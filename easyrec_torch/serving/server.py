"""HTTP model server around an export bundle.

Counterpart of easyrec_tpu/serving/server.py (:38-236) without the
incremental-update channels:

  GET  /health            liveness
  GET  /healthz           readiness: 503 {"status": "loading"} until the
                          forward has run once, then 200 {"status": "warm"}
  GET  /status            model meta, requests and rows served
  POST /predict           {"inputs": [{feature: value, ...}, ...]}
                          -> {"outputs": [{output: value, ...}, ...]};
                          400 on a malformed body, 500 on a serving error

The Predictor runs on the device the service is given (CUDA unless the
caller asks for the CPU). The service warms up before it binds its port
(--no_warmup binds at once); one lock serializes predictions.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np


def _jsonable(v):
  arr = np.asarray(v)
  if arr.ndim == 0:
    return arr.item()
  return arr.tolist()


class PredictorService:
  """Serve one export bundle."""

  def __init__(self, export_dir: str, host: str = '127.0.0.1',
               port: int = 0, batch_size: int = 256,
               warmup: bool = True, device=None):
    from easyrec_torch.export.predictor import Predictor
    self.predictor = Predictor(export_dir, batch_size=batch_size,
                               device=device)
    self.export_dir = export_dir
    self.lock = threading.Lock()
    self.n_requests = 0
    self.n_rows = 0
    self._srv: Optional[ThreadingHTTPServer] = None
    self._threads: List[threading.Thread] = []
    self.host = host
    self.port = port
    self.warmup_enabled = warmup
    # 'loading' until the forward has run once; /healthz answers 503
    # before that so load balancers keep traffic away
    self.state = 'loading'

  def warmup(self) -> float:
    """Run the serving forward once on a default-valued row; returns
    seconds."""
    t0 = time.time()
    with self.lock:
      self.predictor.predict([{}])
    dt = time.time() - t0
    self.state = 'warm'
    logging.info('serving warmup done in %.1f s', dt)
    return dt

  # -- request handling -------------------------------------------------
  def predict_rows(self, rows: List[Dict]) -> List[Dict]:
    with self.lock:
      out = self.predictor.predict(rows)
      self.n_requests += 1
      self.n_rows += len(rows)
    self.state = 'warm'            # no-warmup mode: the first predict warms
    return [{k: _jsonable(v) for k, v in r.items()} for r in out]

  def status(self) -> Dict:
    return {
        'export_dir': self.export_dir,
        'meta': {k: v for k, v in self.predictor.meta.items()
                 if isinstance(v, (str, int, float, bool))},
        'inputs': list(self.predictor.input_names),
        'requests': self.n_requests,
        'rows': self.n_rows,
    }

  # -- server lifecycle -------------------------------------------------
  def start(self) -> str:
    # warm BEFORE binding the port (default): the first request must
    # never pay the first forward's set-up. --no_warmup binds at once;
    # /healthz then reports 'loading' until the first predict.
    if self.warmup_enabled and self.state != 'warm':
      self.warmup()
    service = self

    class Handler(BaseHTTPRequestHandler):
      protocol_version = 'HTTP/1.1'
      # the reply goes out as two writes (headers, then body); with Nagle
      # on, the body waits for the client's delayed ACK, ~40 ms a request
      disable_nagle_algorithm = True

      def log_message(self, *a):
        pass

      def _reply(self, code: int, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header('Content-Type', 'application/json')
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)

      def do_GET(self):
        if self.path == '/health':
          return self._reply(200, {'status': 'ok'})       # liveness
        if self.path == '/healthz':
          warm = service.state == 'warm'
          return self._reply(200 if warm else 503,
                             {'status': service.state})
        if self.path == '/status':
          return self._reply(200, service.status())
        return self._reply(404, {'error': 'not found'})

      def do_POST(self):
        if self.path != '/predict':
          return self._reply(404, {'error': 'not found'})
        try:
          n = int(self.headers.get('Content-Length', 0))
          req = json.loads(self.rfile.read(n))
          rows = req['inputs']
          if not isinstance(rows, list):
            raise ValueError('"inputs" must be a list of objects')
        except Exception as e:           # malformed request: caller error
          return self._reply(400, {'error': str(e)})
        try:
          outputs = service.predict_rows(rows)
          return self._reply(200, {'outputs': outputs})
        except Exception as e:           # serving-side failure: 5xx so
          logging.exception('predict request failed')   # LBs retry/alert
          return self._reply(500, {'error': str(e)})

    srv = ThreadingHTTPServer((self.host, self.port), Handler)
    srv.daemon_threads = True
    self._srv = srv
    self.port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    self._threads = [t]
    logging.info('serving %s at http://%s:%d on %s', self.export_dir,
                 self.host, self.port, self.predictor.device)
    return 'http://%s:%d' % (self.host, self.port)

  def stop(self):
    if self._srv is not None:
      self._srv.shutdown()
      self._srv.server_close()
      self._srv = None
    for t in self._threads:
      t.join(timeout=10)
    self._threads = []


def get_parser():
  import argparse
  parser = argparse.ArgumentParser(description='easyrec_torch model server')
  parser.add_argument('--export_dir', required=True)
  parser.add_argument('--host', default='0.0.0.0')
  parser.add_argument('--port', type=int, default=8080)
  parser.add_argument('--batch_size', type=int, default=256)
  parser.add_argument('--no_warmup', action='store_true',
                      help='bind the port immediately; /healthz stays '
                           '503 "loading" until the first predict')
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu'")
  return parser


def main(argv=None):
  args = get_parser().parse_args(argv)
  logging.basicConfig(
      level=logging.INFO,
      format='[%(levelname)s] %(asctime)s %(filename)s:%(lineno)d : '
             '%(message)s')
  service = PredictorService(
      args.export_dir, host=args.host, port=args.port,
      batch_size=args.batch_size, warmup=not args.no_warmup,
      device=args.device)
  service.start()
  try:
    while True:
      time.sleep(3600)
  except KeyboardInterrupt:
    service.stop()


if __name__ == '__main__':
  main()
