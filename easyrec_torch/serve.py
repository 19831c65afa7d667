"""Model-server CLI: python -m easyrec_torch.serve --export_dir ...

Counterpart of easyrec_tpu/serve.py plus --device (serving/server.py).
Serves on CUDA unless --device cpu is given; --incr_dir, or --kafka_server
with --kafka_topic, follows an incremental-update channel.
"""

from easyrec_torch.serving.server import main

if __name__ == '__main__':
  main()
