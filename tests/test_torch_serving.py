"""The port's model server and CLIs on the CPU: PredictorService's
endpoints (readiness, predict, status, errors, concurrent requests) against
the port's Predictor and against the JAX package's server on the same
weights (a JAX export carried over by convert.py), then the CLI chain
train_eval -> export_cli -> eval -> predict -> serve with --device cpu, each
of which raises without it on a host without CUDA."""

import http.client
import json
import os
import re
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch.export import predictor as t_predictor
from easyrec_torch.serving import client as t_client
from easyrec_torch.serving import server as t_server
from easyrec_tpu.serving import client as j_client
from easyrec_tpu.serving import server as j_server
from tests import fixtures
from tests.test_torch_export import DEEPFM_TOL, _jax_export

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ['label', 'd1', 'd2', 'c1', 'c2', 'c3']


@pytest.fixture(scope='module')
def bundle(tmp_path_factory):
  """A JAX export of the CLI fixture's DeepFM after 3 steps, and the port
  bundle convert.py makes of it."""
  tmp = str(tmp_path_factory.mktemp('serving'))
  path = fixtures.write_pipeline(tmp, num_steps=3, n_train=1024, n_eval=64)
  jax_dir, vs = _jax_export(tmp, path)
  out = convert.jax_export_to_bundle(jax_dir, os.path.join(tmp, 'bundle'),
                                     vs['params'], vs.get('batch_stats'),
                                     vs['tables'], vs['step'])
  with open(os.path.join(tmp, 'eval.csv')) as f:
    rows = [dict(zip(NAMES[1:], line.strip().split(',')[1:]))
            for line in f][:40]
  rows[3] = {'c1': rows[3]['c1']}
  return jax_dir, out, rows


@pytest.fixture
def service(bundle):
  svc = t_server.PredictorService(bundle[1], device='cpu', warmup=False)
  svc.start()
  yield svc
  svc.stop()


def _get(port, path, method='GET', body=None):
  conn = http.client.HTTPConnection('127.0.0.1', port, timeout=30)
  try:
    conn.request(method, path, body=body,
                 headers={'Content-Type': 'application/json'})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read() or b'{}')
  finally:
    conn.close()


def test_healthz_is_loading_until_the_first_predict(service, bundle):
  assert _get(service.port, '/health') == (200, {'status': 'ok'})
  assert _get(service.port, '/healthz') == (503, {'status': 'loading'})
  client = t_client.PredictClient('127.0.0.1:%d' % service.port)
  client.predict(bundle[2][:1])
  client.close()
  assert _get(service.port, '/healthz') == (200, {'status': 'warm'})
  assert _get(service.port, '/nope')[0] == 404


def test_warmup_runs_before_the_port_binds(bundle):
  svc = t_server.PredictorService(bundle[1], device='cpu')
  assert svc.state == 'loading'
  svc.start()
  try:
    assert _get(svc.port, '/healthz') == (200, {'status': 'warm'})
  finally:
    svc.stop()


def test_predict_matches_the_predictor_and_the_jax_server(service, bundle):
  """/predict answers what Predictor.predict does on the same rows, bit for
  bit, and what the JAX server answers on the JAX export of the same
  weights, within the parity tolerance."""
  jax_dir, out, rows = bundle
  client = t_client.PredictClient('127.0.0.1:%d' % service.port)
  got = client.predict(rows)
  client.close()
  want = t_predictor.Predictor(out, batch_size=256,
                               device='cpu').predict(rows)
  assert [sorted(r) for r in got] == [sorted(r) for r in want]
  for key in ('probs', 'logits'):
    assert [r[key] for r in got] == [float(r[key]) for r in want]
  j_svc = j_server.PredictorService(jax_dir, incr_poll_secs=3600,
                                    warmup=False)
  j_svc.start()
  try:
    jc = j_client.PredictClient('127.0.0.1:%d' % j_svc.port)
    j_got = jc.predict(rows)
    jc.close()
  finally:
    j_svc.stop()
  for key in ('probs', 'logits'):
    np.testing.assert_allclose([r[key] for r in got],
                               [r[key] for r in j_got], **DEEPFM_TOL)


def test_bad_requests_and_status(service, bundle):
  """A body that is not JSON, or whose inputs are not a list, is the
  caller's error (400); rows that are not objects fail in serving (500).
  /status counts the requests and rows served."""
  port = service.port
  assert _get(port, '/predict', 'POST', b'{not json')[0] == 400
  code, body = _get(port, '/predict', 'POST', b'{"inputs": "nope"}')
  assert code == 400 and 'list' in body['error']
  assert _get(port, '/predict', 'POST', b'{"rows": []}')[0] == 400
  assert _get(port, '/predict', 'POST', b'{"inputs": [1, 2]}')[0] == 500
  client = t_client.PredictClient('127.0.0.1:%d' % port)
  client.predict(bundle[2][:5])
  client.predict(bundle[2][:7])
  st = client.status()
  client.close()
  assert st['requests'] == 2 and st['rows'] == 12
  assert st['meta']['framework'] == 'easyrec_torch'
  assert st['inputs'] == ['d1', 'd2', 'c1', 'c2', 'c3']


def test_concurrent_requests_all_succeed(service, bundle):
  rows = bundle[2]
  client = t_client.PredictClient('127.0.0.1:%d' % service.port)
  expect = [r['probs'] for r in client.predict(rows)]
  client.close()
  results, errors = {}, []

  def worker(tid):
    c = t_client.PredictClient('127.0.0.1:%d' % service.port)
    try:
      for k in range(5):
        part = rows[tid * 3:tid * 3 + 10]
        results[(tid, k)] = [r['probs'] for r in c.predict(part)]
    except Exception as e:  # collected for the assertion below
      errors.append(e)
    finally:
      c.close()

  threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=120)
  assert not errors and len(results) == 20
  for (tid, _), probs in results.items():
    assert probs == expect[tid * 3:tid * 3 + 10]
  assert service.status()['requests'] == 21


# ------------------------------------------------------------------- CLIs

def _run(args, timeout=300):
  env = dict(os.environ)
  env['PYTHONPATH'] = REPO
  return subprocess.run([sys.executable, '-m'] + args, cwd=REPO, env=env,
                        capture_output=True, text=True, timeout=timeout)


def _serve(export_dir, extra=()):
  """Start the serve CLI on a free port; returns (process, port)."""
  env = dict(os.environ)
  env['PYTHONPATH'] = REPO
  proc = subprocess.Popen(
      [sys.executable, '-m', 'easyrec_torch.serve', '--export_dir',
       export_dir, '--host', '127.0.0.1', '--port', '0', '--no_warmup'] +
      list(extra), cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
  for line in proc.stderr:
    m = re.search(r'serving .* at http://127\.0\.0\.1:(\d+)', line)
    if m:
      return proc, int(m.group(1))
  proc.wait(timeout=60)
  return proc, None


def test_cli_chain_on_the_cpu(tmp_path):
  """train_eval, export_cli, eval, predict (from the checkpoint and from
  the export) and serve, all with --device cpu, on the CLI fixture."""
  path = fixtures.write_pipeline(tmp_path, num_steps=30, n_train=1024,
                                 n_eval=300)
  md = os.path.join(tmp_path, 'ckpt')
  r = _run(['easyrec_torch.train_eval', '--pipeline_config_path', path,
            '--device', 'cpu'])
  assert r.returncode == 0, r.stderr[-3000:]
  assert 'exported serving model to' in r.stderr
  out = os.path.join(tmp_path, 'exp')
  r = _run(['easyrec_torch.export_cli', '--pipeline_config_path', path,
            '--export_dir', out, '--checkpoint_path',
            os.path.join(md, 'checkpoints', '30'), '--device', 'cpu'])
  assert r.returncode == 0, r.stderr[-3000:]
  (stamp,) = os.listdir(out)
  export_dir = os.path.join(out, stamp)
  r = _run(['easyrec_torch.eval', '--pipeline_config_path', path,
            '--eval_result_filename', 'cli_eval.txt', '--device', 'cpu'])
  assert r.returncode == 0, r.stderr[-3000:]
  with open(os.path.join(md, 'cli_eval.txt')) as f:
    assert 0.5 < json.load(f)['auc'] <= 1.0
  r = _run(['easyrec_torch.predict', '--pipeline_config_path', path,
            '--output_path', os.path.join(tmp_path, 'ckpt.csv'),
            '--device', 'cpu'])
  assert r.returncode == 0, r.stderr[-3000:]
  r = _run(['easyrec_torch.predict', '--saved_model_dir', export_dir,
            '--input_path', os.path.join(tmp_path, 'eval.csv'),
            '--output_path', os.path.join(tmp_path, 'saved.csv'),
            '--reserved_cols', 'c1', '--device', 'cpu'])
  assert r.returncode == 0, r.stderr[-3000:]
  with open(os.path.join(tmp_path, 'ckpt.csv')) as f:
    from_ckpt = [line.strip().split(',') for line in f]
  with open(os.path.join(tmp_path, 'saved.csv')) as f:
    from_export = [line.strip().split(',') for line in f]
  assert from_ckpt[0] == ['logits', 'probs']
  assert from_export[0] == ['c1', 'logits', 'probs']
  assert len(from_ckpt) == len(from_export) == 301
  np.testing.assert_allclose(np.float64([r[1] for r in from_ckpt[1:]]),
                             np.float64([r[2] for r in from_export[1:]]),
                             rtol=1e-6, atol=1e-7)

  proc, port = _serve(export_dir, ['--device', 'cpu'])
  try:
    assert port is not None
    assert _get(port, '/healthz') == (503, {'status': 'loading'})
    code, body = _get(port, '/predict', 'POST', json.dumps(
        {'inputs': [{'d1': '0.5', 'c1': 'u3'}]}).encode())
    assert code == 200 and 0.0 < body['outputs'][0]['probs'] < 1.0
    assert _get(port, '/healthz') == (200, {'status': 'warm'})
  finally:
    proc.terminate()
    proc.wait(timeout=60)
    proc.stderr.close()


@pytest.mark.parametrize('cli', ['eval', 'predict', 'export_cli', 'serve'])
def test_each_cli_raises_without_the_device_flag(cli, bundle, tmp_path):
  """Without --device cpu each CLI asks for CUDA and, where CUDA is
  missing, exits with the device error instead of running on the CPU."""
  if torch.cuda.is_available():
    pytest.skip('CUDA is present: the default device is the card')
  path = fixtures.write_pipeline(tmp_path, num_steps=3)
  args = {
      'eval': ['--pipeline_config_path', path],
      'predict': ['--saved_model_dir', bundle[1], '--input_path',
                  os.path.join(tmp_path, 'eval.csv'), '--output_path',
                  os.path.join(tmp_path, 'out.csv')],
      'export_cli': ['--pipeline_config_path', path],
      'serve': ['--export_dir', bundle[1], '--port', '0'],
  }[cli]
  r = _run(['easyrec_torch.%s' % cli] + args, timeout=120)
  assert r.returncode != 0
  assert 'torch.cuda.is_available() is False' in r.stderr
