"""Minimal pure-Python Aliyun DataHub REST client.

A copy of easyrec_tpu/data/datahub_client.py (standard library only). The
port's incremental-update channel (train/incremental.py,
export/predictor.py) publishes and consumes through it.

The reference consumes DataHub through the `pydatahub` SDK
(easy_rec/python/input/datahub_input.py:39 — list_shard / get_cursor /
get_records over the service's JSON REST API). The SDK is not in this
environment, and the consumer slice of the API is small, so this module
speaks the REST protocol directly:

  GET  /projects/{p}/topics/{t}           — topic meta + record schema
  GET  /projects/{p}/topics/{t}/shards    — shard listing
  POST /projects/{p}/topics/{t}/shards/{s}
       {"Action": "cursor", ...}          — OLDEST/LATEST/SEQUENCE cursors
       {"Action": "sub", "Cursor": ...}   — TUPLE record reads

Requests carry the DataHub signature header (base64 HMAC-SHA1 over the
canonical string, `Authorization: DATAHUB <akId>:<sig>`). The consumer
slice plus TUPLE produce (`put_records` — the incremental-update publish
channel, reference estimator_utils.py:357-466) is implemented: no BLOB
topics, no pb-batch transport (plain JSON).

Cursor semantics pinned by the client/mock pair (tests/datahub_mock.py):
LATEST is past-the-end (the next sequence to be written), so draining
`seq < latest` reads everything — mirrors Kafka's high watermark.
"""

from __future__ import annotations

import base64
import email.utils
import hashlib
import hmac
import http.client
import json
from typing import Dict, List, Optional, Tuple

OLDEST = 'OLDEST'
LATEST = 'LATEST'
SEQUENCE = 'SEQUENCE'


class DataHubError(RuntimeError):
  pass


class DataHubClient:

  def __init__(self, endpoint: str, access_id: str, access_key: str,
               timeout: float = 30.0):
    endpoint = endpoint.replace('https://', '').replace('http://', '')
    host, _, port = endpoint.partition(':')
    self.host = host
    self.port = int(port or 80)
    self.access_id = access_id
    self.access_key = access_key
    self.timeout = timeout
    self._conn: Optional[http.client.HTTPConnection] = None

  def close(self):
    if self._conn is not None:
      try:
        self._conn.close()
      finally:
        self._conn = None

  # -- transport --------------------------------------------------------
  def _sign(self, method: str, content_type: str, date: str,
            dh_headers: List[Tuple[str, str]], resource: str) -> str:
    canon = ''.join('%s:%s\n' % (k.lower(), v)
                    for k, v in sorted(dh_headers))
    to_sign = '%s\n%s\n%s\n%s%s' % (method, content_type, date, canon,
                                    resource)
    digest = hmac.new(self.access_key.encode(), to_sign.encode(),
                      hashlib.sha1).digest()
    return base64.b64encode(digest).decode()

  def _request(self, method: str, path: str,
               body: Optional[dict] = None) -> dict:
    payload = json.dumps(body).encode() if body is not None else b''
    content_type = 'application/json'
    date = email.utils.formatdate(usegmt=True)
    dh_headers = [('x-datahub-client-version', '1.1')]
    sig = self._sign(method, content_type, date, dh_headers, path)
    headers = {
        'Content-Type': content_type,
        'Date': date,
        'Authorization': 'DATAHUB %s:%s' % (self.access_id, sig),
    }
    headers.update(dh_headers)
    if self._conn is None:
      self._conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=self.timeout)
    try:
      self._conn.request(method, path, body=payload or None,
                         headers=headers)
      resp = self._conn.getresponse()
      data = resp.read()
    except (OSError, http.client.HTTPException):
      self.close()
      raise
    if resp.status >= 300:
      self.close()
      raise DataHubError('%s %s -> %d: %s'
                         % (method, path, resp.status, data[:500]))
    return json.loads(data) if data else {}

  # -- api --------------------------------------------------------------
  def get_topic(self, project: str, topic: str) -> List[Tuple[str, str]]:
    """Record schema as [(field_name, field_type)] (TUPLE topics)."""
    res = self._request('GET', '/projects/%s/topics/%s' % (project, topic))
    schema = res.get('RecordSchema', '{}')
    if isinstance(schema, str):          # service returns a JSON string
      schema = json.loads(schema)
    return [(f['name'], f['type']) for f in schema.get('fields', [])]

  def list_shards(self, project: str, topic: str) -> List[str]:
    res = self._request('GET',
                        '/projects/%s/topics/%s/shards' % (project, topic))
    return sorted((s['ShardId'] for s in res.get('Shards', [])
                   if s.get('State', 'ACTIVE') == 'ACTIVE'), key=int)

  def get_cursor(self, project: str, topic: str, shard_id: str,
                 ctype: str = OLDEST,
                 sequence: Optional[int] = None) -> Tuple[str, int]:
    """-> (cursor, sequence). LATEST = past-the-end (see module doc)."""
    body = {'Action': 'cursor', 'Type': ctype}
    if ctype == SEQUENCE:
      body['Sequence'] = int(sequence)
    res = self._request(
        'POST', '/projects/%s/topics/%s/shards/%s'
        % (project, topic, shard_id), body)
    return res['Cursor'], int(res['Sequence'])

  def get_records(self, project: str, topic: str, shard_id: str,
                  cursor: str, limit: int = 1000):
    """-> (records, next_cursor); records = [(sequence, [field, ...])],
    field values are strings (None for null)."""
    res = self._request(
        'POST', '/projects/%s/topics/%s/shards/%s'
        % (project, topic, shard_id),
        {'Action': 'sub', 'Cursor': cursor, 'Limit': int(limit)})
    records = [(int(r['Sequence']), r['Data'])
               for r in res.get('Records', [])]
    return records, res.get('NextCursor', cursor)

  def put_records(self, project: str, topic: str, shard_id: str,
                  rows) -> int:
    """Publish TUPLE records (each row = list of string field values)
    to one shard; returns the count written (produce side of the
    incremental-update channel)."""
    body = {'Action': 'pub',
            'Records': [{'ShardId': shard_id, 'Data': list(r)}
                        for r in rows]}
    res = self._request(
        'POST', '/projects/%s/topics/%s/shards' % (project, topic), body)
    failed = int(res.get('FailedRecordCount', 0))
    if failed:
      raise DataHubError('put_records: %d rows failed: %s'
                         % (failed, res.get('FailedRecords')))
    return len(body['Records'])
