"""HTTP client for the model server (serving/server.py): plain JSON
requests over one kept-alive connection.

The port's copy of easyrec_tpu/serving/client.py, which imports nothing of
JAX."""

from __future__ import annotations

import http.client
import json
from typing import Dict, List, Optional


class PredictClient:

  def __init__(self, endpoint: str, timeout: float = 30.0):
    endpoint = endpoint.replace('http://', '')
    host, _, port = endpoint.partition(':')
    self.host = host
    self.port = int(port or 80)
    self.timeout = timeout
    self._conn: Optional[http.client.HTTPConnection] = None

  def _request(self, method: str, path: str,
               body: Optional[dict] = None) -> dict:
    if self._conn is None:
      self._conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=self.timeout)
    payload = json.dumps(body).encode() if body is not None else None
    try:
      self._conn.request(method, path, body=payload,
                         headers={'Content-Type': 'application/json'})
      resp = self._conn.getresponse()
      data = resp.read()
    except (OSError, http.client.HTTPException):
      self.close()
      raise
    out = json.loads(data) if data else {}
    if resp.status >= 300:
      raise RuntimeError('%s %s -> %d: %s'
                         % (method, path, resp.status, out))
    return out

  def predict(self, rows: List[Dict]) -> List[Dict]:
    """[{feature: value, ...}] -> [{output: value, ...}]."""
    return self._request('POST', '/predict', {'inputs': rows})['outputs']

  def status(self) -> Dict:
    return self._request('GET', '/status')

  def health(self) -> bool:
    try:
      return self._request('GET', '/health').get('status') == 'ok'
    except (OSError, RuntimeError):
      return False

  def close(self):
    if self._conn is not None:
      try:
        self._conn.close()
      finally:
        self._conn = None
