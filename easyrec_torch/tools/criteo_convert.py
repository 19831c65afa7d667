"""Pack Criteo's TSV logs into the binary layout CriteoInput reads.

Counterpart of easyrec_tpu/tools/criteo_convert.py, with the same output
byte for byte: each `day_*` TSV line (label, 13 integer dense features, 26
hex categorical ids, tab-separated) becomes one record of 40 int32
(data/input_pipeline.py CriteoBinaryReader), one output file per input
file. A missing value becomes 0, and a line of fewer fields is padded with
missing ones; a hex id keeps its low 32 bits, so an id of 0x80000000 or
above is stored, and read back, as a negative int32. The fields of a chunk
of lines are converted column by column rather than record by record.

  python -m easyrec_torch.tools.criteo_convert \
      --input_path 'data/day_*.tsv' --output_dir data/bin [--gzip]
"""

from __future__ import annotations

import argparse
import glob
import gzip
import os
import sys

import numpy as np

N_DENSE = 13
N_CAT = 26
RECORD_INTS = 1 + N_DENSE + N_CAT


def _hex_ids(col) -> np.ndarray:
  """A column of hex ids ('' for none) -> their low 32 bits. Where every
  id is 8 hex digits (Criteo's), one bytes.fromhex of the column; where
  that fails or reads another length, int(v, 16) of each."""
  if set(map(len, col)) <= {0, 8}:
    try:
      raw = bytes.fromhex(''.join([v or '00000000' for v in col]))
    except ValueError:
      raw = b''
    if len(raw) == 4 * len(col):
      return np.frombuffer(raw, dtype='>u4').astype(np.int64)
  return np.fromiter((int(v, 16) & 0xFFFFFFFF if v else 0 for v in col),
                     np.int64, len(col))


def pack_lines(lines) -> np.ndarray:
  """TSV lines -> [n, 40] int32 records."""
  rows = []
  for line in lines:
    parts = line.rstrip('\n').split('\t')[:RECORD_INTS]
    rows.append(parts + [''] * (RECORD_INTS - len(parts)))
  out = np.zeros((len(rows), RECORD_INTS), dtype=np.int64)
  if not rows:
    return out.astype(np.int32)
  cols = list(zip(*rows))
  for i in range(1 + N_DENSE):
    out[:, i] = np.fromiter((int(v) if v else 0 for v in cols[i]), np.int64,
                            len(rows))
  for i in range(1 + N_DENSE, RECORD_INTS):
    out[:, i] = _hex_ids(cols[i])
  return out.astype(np.int32)


def convert_file(in_path: str, out_path: str, chunk_rows: int = 1 << 18,
                 is_gzip: bool = False) -> int:
  """Pack one TSV file; returns the record count."""
  opener = gzip.open if (is_gzip or in_path.endswith('.gz')) else open
  n_total = 0
  with opener(in_path, 'rt') as f, open(out_path, 'wb') as out:
    lines = []
    for line in f:
      lines.append(line)
      if len(lines) >= chunk_rows:
        pack_lines(lines).tofile(out)
        n_total += len(lines)
        lines = []
    if lines:
      pack_lines(lines).tofile(out)
      n_total += len(lines)
  return n_total


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--input_path', required=True,
                      help='TSV file or glob (day_0, day_1.gz, ...)')
  parser.add_argument('--output_dir', required=True)
  parser.add_argument('--gzip', action='store_true',
                      help='inputs are gzip-compressed')
  args = parser.parse_args(argv)

  paths = sorted(glob.glob(args.input_path)) or [args.input_path]
  os.makedirs(args.output_dir, exist_ok=True)
  total = 0
  for p in paths:
    base = os.path.basename(p)
    for suf in ('.gz', '.tsv', '.txt'):
      if base.endswith(suf):
        base = base[:-len(suf)]
    out = os.path.join(args.output_dir, base + '.bin')
    n = convert_file(p, out, is_gzip=args.gzip)
    total += n
    print('%s -> %s (%d records)' % (p, out, n), file=sys.stderr)
  print('converted %d records from %d files' % (total, len(paths)),
        file=sys.stderr)


if __name__ == '__main__':
  main()
