"""The port's Parquet readers on the CPU, against the JAX package's.

The port reads Parquet with a decoder of its own (easyrec_torch/data/
parquet.py), its loops in native code (ops/native/parquet_ops.cc): each
native function is held to its plain Python version bit for bit, on inputs
made here and on pages pyarrow writes. Then the port's ParquetReader is
held to the JAX ParquetReader (pyarrow) on files pyarrow writes: every
chunk value for value and type for type, and every pipeline batch
exactly, across codecs, data page versions, dictionaries on and off, each
DELTA encoding and BYTE_STREAM_SPLIT, nulls under defaults, list columns,
several row groups and files, file and row shards, chunk sizes that cut
row groups, and the warehouse's Parquet export. The codecs and types the
port does not read raise, naming the codec or type, the file and the
column."""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from easyrec_torch.config import config_util as t_config
from easyrec_torch.data import input_pipeline as t_ip
from easyrec_torch.data import parquet as t_pq
from easyrec_torch.ops import parquet_ops as po
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.data import input_pipeline as j_ip


# -- the native decoders against their plain versions ----------------------


def _same(a, b):
  """Two decoder results equal bit for bit (arrays by bytes and dtype)."""
  assert type(a) is type(b)
  if isinstance(a, tuple):
    assert len(a) == len(b)
    for x, y in zip(a, b):
      _same(x, y)
  elif isinstance(a, np.ndarray):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()
  else:
    assert a == b


def _both(name, *args):
  """The native function and its plain version on the same inputs: equal
  results, or both raise ParquetFormatError."""
  native, plain = getattr(po, name), getattr(po, 'plain_' + name)
  try:
    want = plain(*args)
  except po.ParquetFormatError:
    with pytest.raises(po.ParquetFormatError):
      native(*args)
    return None
  got = native(*args)
  _same(got, want)
  return got


def _uleb(v):
  out = bytearray()
  while True:
    b = v & 0x7f
    v >>= 7
    out.append(b | (0x80 if v else 0))
    if not v:
      return bytes(out)


def _hybrid(values, bit_width, rng):
  """The RLE / bit-packed hybrid of `values`, runs of both kinds."""
  out = bytearray()
  i = 0
  while i < len(values):
    if rng.random() < 0.5:
      n = int(rng.integers(1, 20))
      run = values[i:i + n]
      if all(v == run[0] for v in run):
        out += _uleb(len(run) << 1)
        out += int(run[0]).to_bytes((bit_width + 7) // 8, 'little')
        i += len(run)
        continue
    groups = int(rng.integers(1, 4))
    chunk = list(values[i:i + 8 * groups])
    chunk += [0] * (8 * groups - len(chunk))
    out += _uleb((groups << 1) | 1)
    bits = 0
    for k, v in enumerate(chunk):
      bits |= int(v) << (k * bit_width)
    out += bits.to_bytes(groups * bit_width, 'little')
    i += 8 * groups
  return bytes(out)


@pytest.mark.parametrize('bit_width', [0, 1, 2, 3, 7, 8, 13, 20, 32])
def test_rle_bit_packed_hybrid(bit_width):
  rng = np.random.default_rng(bit_width)
  for n in (1, 7, 8, 100, 1000):
    vals = rng.integers(0, 1 << bit_width, n, dtype=np.uint64) if bit_width \
        else np.zeros(n, np.uint64)
    # runs of repeats among the values
    vals[n // 3:n // 2] = vals[n // 3]
    enc = b'\x05' + _hybrid(vals.tolist(), bit_width, rng) + b'\x09'
    got, end = _both('rle_bp_decode', enc, 1, len(enc) - 1, bit_width, n)
    assert got.view(np.uint32).tolist() == vals.tolist()
    assert end <= len(enc) - 1
  # truncated runs, and a last bit-packed run holding only the values still
  # needed, raise or decode alike
  enc = _uleb((2 << 1) | 1) + bytes(range(2 * bit_width))
  for n, end in ((3, len(enc)), (16, len(enc)), (16, len(enc) - 1),
                 (5, 1 + (5 * bit_width + 7) // 8)):
    _both('rle_bp_decode', enc, 0, end, bit_width, n)


@pytest.mark.parametrize('case', ['random', 'repeats', 'long_literal',
                                  'pyarrow_pages'])
def test_snappy(case, tmp_path):
  rng = np.random.default_rng(3)
  if case == 'pyarrow_pages':
    path = str(tmp_path / 's.parquet')
    pq.write_table(_table(2000, 5), path, compression='snappy',
                   row_group_size=700)
    pf = t_pq.ParquetFile(path)
    n = 0
    for name in pf.names:
      for header, body in pf.pages(0, name):
        if header[1] == t_pq.DATA_PAGE_V2:
          continue
        got = _both('snappy_decompress', body, header[2])
        assert got.size == header[2]
        n += 1
    assert n > 10
    return
  if case == 'random':
    data = rng.integers(0, 256, 70000).astype(np.uint8).tobytes()
  elif case == 'repeats':
    data = b''.join(b'ab' * int(rng.integers(1, 40)) + b'xyz%d' % i
                    for i in range(3000))
  else:
    data = bytes(rng.integers(0, 256, 300).astype(np.uint8)) * 400
  comp = pa.compress(data, codec='snappy', asbytes=True)
  assert _both('snappy_decompress', comp, len(data)).tobytes() == data
  # a wrong length, a cut block, a copy before the start
  _both('snappy_decompress', comp, len(data) + 1)
  _both('snappy_decompress', comp[:len(comp) // 2], len(data))
  _both('snappy_decompress', b'\x08\x05\x10\x00', 8)


def test_byte_arrays():
  rng = np.random.default_rng(4)
  words = [bytes(rng.integers(0, 256, int(rng.integers(0, 30)),
                              dtype=np.uint8)) for _ in range(500)]
  plain = b'\x00\x01' + b''.join(len(w).to_bytes(4, 'little') + w
                                 for w in words)
  data, offsets, end = _both('split_byte_array', plain, 2, len(plain), 500)
  assert end == len(plain)
  assert [data[a:b].tobytes() for a, b in zip(offsets[:-1], offsets[1:])] \
      == words
  _both('split_byte_array', plain, 2, len(plain) - 1, 500)
  # a span outside the buffer raises before any native read
  for pos, end in ((2, len(plain) + 8), (-1, 10), (9, 8)):
    for fn in (po.split_byte_array, po.plain_split_byte_array):
      with pytest.raises(po.ParquetFormatError, match='outside a buffer'):
        fn(plain, pos, end, 500)
  idx = rng.integers(0, 500, 2000).astype(np.int32)
  gd, go = _both('gather_byte_array', data, offsets, idx)
  assert [gd[a:b].tobytes() for a, b in zip(go[:-1], go[1:])] == \
      [words[i] for i in idx]
  for bad in (500, -1):
    _both('gather_byte_array', data, offsets, np.array([0, bad], np.int32))
  # DELTA_BYTE_ARRAY's build: shared prefixes of the value before
  vals = sorted(set(b'key%05d' % v for v in rng.integers(0, 10 ** 5, 300)))
  prefix = [0] + [len(os.path.commonprefix([a, b]))
                  for a, b in zip(vals[:-1], vals[1:])]
  sufs = [v[p:] for v, p in zip(vals, prefix)]
  soff = np.concatenate([[0], np.cumsum([len(s) for s in sufs])])
  bd, bo = _both('delta_byte_array_build', np.array(prefix, np.int64),
                 np.frombuffer(b''.join(sufs), np.uint8), soff)
  assert [bd[a:b].tobytes() for a, b in zip(bo[:-1], bo[1:])] == vals
  prefix[5] = 100
  _both('delta_byte_array_build', np.array(prefix, np.int64),
        np.frombuffer(b''.join(sufs), np.uint8), soff)


def _value_pages(tmp_path, table, encoding):
  """The data pages of `table`'s REQUIRED columns written uncompressed
  with `encoding` and no dictionary (V1 pages of values only)."""
  path = str(tmp_path / ('%s.parquet' % encoding))
  pq.write_table(table, path, compression='none', use_dictionary=False,
                 column_encoding=encoding, data_page_size=2000)
  pf = t_pq.ParquetFile(path)
  for name in pf.names:
    for header, body in pf.pages(0, name):
      assert header[5][2] == {'DELTA_BINARY_PACKED': 5,
                              'DELTA_LENGTH_BYTE_ARRAY': 6,
                              'DELTA_BYTE_ARRAY': 7}[encoding]
      yield name, header[5][1], body


@pytest.mark.parametrize('width', [32, 64])
def test_delta_binary_packed(width, tmp_path):
  rng = np.random.default_rng(width)
  n = 5000
  dt = np.int32 if width == 32 else np.int64
  info = np.iinfo(dt)
  cols = {
      'walk': np.cumsum(rng.integers(-50, 50, n)).astype(dt),
      'wide': rng.integers(info.min, info.max, n, dtype=dt),
      'const': np.full(n, 7, dt),
      'sorted': np.sort(rng.integers(0, 1 << 20, n)).astype(dt),
  }
  table = pa.table({k: pa.array(v) for k, v in cols.items()},
                   schema=pa.schema([pa.field(k, pa.from_numpy_dtype(dt),
                                              nullable=False)
                                     for k in cols]))
  seen = {k: [] for k in cols}
  for name, count, body in _value_pages(tmp_path, table,
                                        'DELTA_BINARY_PACKED'):
    got, end = _both('delta_binary_packed', body, 0, body.size, width, count)
    assert end == body.size
    seen[name].append(got)
    _both('delta_binary_packed', body, 0, body.size, width, count + 1)
    _both('delta_binary_packed', body, 0, body.size - 1, width, count)
  for k, v in cols.items():
    np.testing.assert_array_equal(np.concatenate(seen[k]), v)


@pytest.mark.parametrize('encoding', ['DELTA_LENGTH_BYTE_ARRAY',
                                      'DELTA_BYTE_ARRAY'])
def test_delta_byte_arrays(encoding, tmp_path):
  rng = np.random.default_rng(5)
  words = ['w%d/%s' % (i // 7, 'x' * int(rng.integers(0, 9)))
           for i in range(3000)]
  table = pa.table({'s': pa.array(words)},
                   schema=pa.schema([pa.field('s', pa.string(),
                                              nullable=False)]))
  fn = encoding.lower()
  got_all = []
  for _, count, body in _value_pages(tmp_path, table, encoding):
    data, offsets, end = _both(fn, body, 0, body.size, count)
    assert end == body.size
    got_all += [data[a:b].tobytes().decode()
                for a, b in zip(offsets[:-1], offsets[1:])]
    _both(fn, body, 0, body.size - 3, count)
  assert got_all == words


# -- the reader against the JAX package's ------------------------------------


def _table(n, seed):
  """n rows of every type the readers share: nulls in most columns, list
  columns with null and empty rows and null elements."""
  rng = np.random.default_rng(seed)

  def maybe(v, p=0.1):
    return None if rng.random() < p else v

  return pa.table({
      'label': pa.array((rng.random(n) < 0.3).astype(np.float32)),
      'i32': pa.array(rng.integers(-1000, 1000, n).astype(np.int32)),
      'i64': pa.array([maybe(int(v)) for v in
                       rng.integers(-2 ** 40, 2 ** 40, n)], pa.int64()),
      'u32': pa.array(rng.integers(0, 2 ** 32 - 1, n).astype(np.uint32)),
      'i8': pa.array([maybe(int(v)) for v in rng.integers(-128, 127, n)],
                     pa.int8()),
      'f32': pa.array([maybe(float(v)) for v in rng.normal(size=n)],
                      pa.float32()),
      'f64': pa.array(rng.normal(size=n)),
      'flag': pa.array([maybe(bool(v)) for v in rng.integers(0, 2, n)]),
      'cat': pa.array([maybe('c%d' % v) for v in rng.integers(0, 300, n)]),
      'user': pa.array(['' if r < 0.05 else None if r < 0.1 else 'u%d' % v
                        for r, v in zip(rng.random(n),
                                        rng.integers(0, 5000, n))]),
      'tags': pa.array([maybe(['t%d' % rng.integers(0, 30)
                               for _ in range(rng.integers(0, 5))])
                        for _ in range(n)], pa.list_(pa.string())),
      'seq': pa.array([maybe([maybe('s%d' % rng.integers(0, 20), 0.05)
                              for _ in range(rng.integers(0, 7))])
                       for _ in range(n)], pa.list_(pa.string())),
      'vec': pa.array([maybe(rng.normal(size=3).tolist())
                       for _ in range(n)], pa.list_(pa.float64())),
      'ivec': pa.array([[int(v) for v in rng.integers(0, 9, 2)]
                        for _ in range(n)], pa.list_(pa.int32())),
  })


CONFIG = """
data_config {
  batch_size: %(batch)d
  num_epochs: 1
  shuffle: %(shuffle)s
  shuffle_buffer_size: 2
  file_shard: %(file_shard)s
  label_fields: "label"
  input_fields { input_name: "label" input_type: FLOAT }
  input_fields { input_name: "i32" input_type: INT32 }
  input_fields { input_name: "i64" input_type: INT64 default_val: "7" }
  input_fields { input_name: "u32" input_type: INT64 }
  input_fields { input_name: "i8" input_type: INT32 default_val: "-3" }
  input_fields { input_name: "f32" input_type: FLOAT default_val: "0.5" }
  input_fields { input_name: "f64" input_type: DOUBLE }
  input_fields { input_name: "flag" input_type: BOOL default_val: "true" }
  input_fields { input_name: "cat" input_type: STRING default_val: "none" }
  input_fields { input_name: "user" input_type: STRING }
  input_fields { input_name: "tags" input_type: STRING }
  input_fields { input_name: "seq" input_type: STRING }
  input_fields { input_name: "vec" input_type: STRING }
  input_fields { input_name: "ivec" input_type: STRING }
  input_type: %(input_type)s
}
feature_config {
  features { input_names: "i32" feature_type: RawFeature }
  features { input_names: "i64" feature_type: IdFeature
             embedding_dim: 4 hash_bucket_size: 97 }
  features { input_names: "u32" feature_type: IdFeature
             embedding_dim: 4 num_buckets: 1000 }
  features { input_names: "i8" feature_type: RawFeature
             boundaries: [-50, 0, 50] embedding_dim: 4 }
  features { input_names: "f32" feature_type: RawFeature }
  features { input_names: "f64" feature_type: RawFeature }
  features { input_names: "flag" feature_type: RawFeature }
  features { input_names: "cat" feature_type: IdFeature
             embedding_dim: 4 hash_bucket_size: 50 }
  features { input_names: "user" feature_type: IdFeature
             embedding_dim: 4 hash_bucket_size: 500 }
  features { input_names: "tags" feature_type: TagFeature
             embedding_dim: 4 hash_bucket_size: 50 max_multi_len: 4 }
  features { input_names: "seq" feature_type: SequenceFeature
             embedding_dim: 4 hash_bucket_size: 30 max_seq_len: 5 }
  features { input_names: "vec" feature_type: RawFeature raw_input_dim: 3 }
  features { input_names: "ivec" feature_type: TagFeature separator: ","
             embedding_dim: 4 hash_bucket_size: 20 max_multi_len: 2 }
}
model_config { model_class: "DummyModel" }
"""


def _configs(batch=64, shuffle=False, file_shard=False,
             input_type='ParquetInput'):
  text = CONFIG % {'batch': batch, 'shuffle': str(shuffle).lower(),
                   'file_shard': str(file_shard).lower(),
                   'input_type': input_type}
  return (j_config.get_configs_from_pipeline_str(text),
          t_config.get_configs_from_pipeline_str(text))


def _write(tmp_path, n_files=1, rows=1000, row_group_size=300, **kw):
  paths = []
  for i in range(n_files):
    path = str(tmp_path / ('part-%d.parquet' % i))
    pq.write_table(_table(rows + 37 * i, seed=11 + i), path,
                   row_group_size=row_group_size, **kw)
    paths.append(path)
  return paths


def _pylist(col):
  """A port column's values as Python values (pyarrow's to_pylist)."""
  return col.tolist()


def _same_chunks(jc, tc, path, chunk_rows, shard=(0, 1)):
  """Both packages' readers over `path`: the same chunks, value for value,
  each column's numpy type the JAX column's; returns the chunk sizes."""
  jr = j_ip.create_reader(jc.data_config, path, *shard)
  tr = t_ip.create_reader(tc.data_config, path, *shard)
  assert type(tr).__name__ == type(jr).__name__ == 'ParquetReader'
  jchunks = list(jr.chunks(chunk_rows))
  tchunks = list(tr.chunks(chunk_rows))
  sizes = [len(c['label']) for c in tchunks]
  assert sizes == [len(c['label']) for c in jchunks]
  for i, (jc_, tc_) in enumerate(zip(jchunks, tchunks)):
    assert list(tc_) == list(jc_)
    for name, jcol in jc_.items():
      tcol = tc_[name]
      assert _pylist(tcol) == jcol.to_pylist(), (i, name)
      typ = jcol.type
      if pa.types.is_list(typ) or pa.types.is_string(typ) or \
          jcol.null_count:
        assert tcol.dtype == object, (name, tcol.dtype)
      else:
        assert tcol.dtype == np.dtype(typ.to_pandas_dtype()), name
  return sizes


def _same_batches(jc, tc, path, mode='eval', shard=(0, 1)):
  """Both packages' pipelines over `path`: every batch equal, key for key
  and dtype for dtype; returns the live row count."""
  jp = j_ip.InputPipeline(jc.data_config, j_config.get_feature_configs(jc),
                          path, mode=mode, shard_index=shard[0],
                          shard_num=shard[1])
  tp = t_ip.InputPipeline(tc.data_config, t_config.get_feature_configs(tc),
                          path, mode=mode, shard_index=shard[0],
                          shard_num=shard[1])
  jbs, tbs = list(jp), list(tp)
  assert len(tbs) == len(jbs)
  for i, (jb, tb) in enumerate(zip(jbs, tbs)):
    assert sorted(tb) == sorted(jb)
    for k in jb:
      np.testing.assert_array_equal(tb[k], jb[k], err_msg='%d %s' % (i, k))
      assert tb[k].dtype == jb[k].dtype, k
  return int(sum((b['sample_weight'] > 0).sum() for b in tbs))


@pytest.mark.parametrize('codec', ['none', 'snappy', 'gzip'])
@pytest.mark.parametrize('version', ['1.0', '2.0'])
@pytest.mark.parametrize('dictionary', [True, False])
def test_codecs_pages_and_dictionaries(codec, version, dictionary, tmp_path):
  paths = _write(tmp_path, compression=codec, data_page_version=version,
                 use_dictionary=dictionary, data_page_size=4096)
  meta = pq.ParquetFile(paths[0]).metadata
  assert meta.num_row_groups == 4
  encs = set(meta.row_group(0).column(8).encodings)
  assert ('RLE_DICTIONARY' in encs) == dictionary
  jc, tc = _configs()
  assert _same_chunks(jc, tc, paths[0], 256) == [256, 256, 256, 232]
  assert _same_batches(jc, tc, paths[0]) == 1000


@pytest.mark.parametrize('encoding', ['DELTA_BINARY_PACKED',
                                      'DELTA_LENGTH_BYTE_ARRAY',
                                      'DELTA_BYTE_ARRAY', 'BYTE_STREAM_SPLIT'])
def test_column_encodings(encoding, tmp_path):
  columns = {'DELTA_BINARY_PACKED': ['i32', 'i64', 'u32', 'i8', 'ivec'],
             'DELTA_LENGTH_BYTE_ARRAY': ['cat', 'user', 'tags'],
             'DELTA_BYTE_ARRAY': ['cat', 'user', 'seq'],
             'BYTE_STREAM_SPLIT': ['f32', 'f64', 'vec']}[encoding]
  paths = _write(tmp_path, use_dictionary=False, data_page_version='2.0',
                 compression='snappy',
                 column_encoding={c: encoding for c in columns})
  meta = pq.ParquetFile(paths[0]).metadata.row_group(0)
  names = pq.ParquetFile(paths[0]).schema_arrow.names
  assert encoding in meta.column(names.index(columns[0])).encodings
  jc, tc = _configs()
  _same_chunks(jc, tc, paths[0], 500)
  _same_batches(jc, tc, paths[0])


def test_dictionary_falls_back_to_plain_within_a_chunk(tmp_path):
  """pyarrow's string dictionary past its page limit falls back to PLAIN
  partway through the column chunk: both kinds of pages in one chunk."""
  paths = _write(tmp_path, rows=3000, row_group_size=3000,
                 dictionary_pagesize_limit=2048, data_page_size=1024)
  meta = pq.ParquetFile(paths[0]).metadata.row_group(0)
  assert {'PLAIN', 'RLE_DICTIONARY'} <= set(meta.column(9).encodings)
  jc, tc = _configs()
  _same_chunks(jc, tc, paths[0], 1024)
  _same_batches(jc, tc, paths[0])


@pytest.mark.parametrize('chunk_rows', [100, 256, 300, 1000, 4096])
def test_chunks_cut_across_row_groups(chunk_rows, tmp_path):
  paths = _write(tmp_path, n_files=2)
  jc, tc = _configs()
  sizes = _same_chunks(jc, tc, ','.join(paths), chunk_rows)
  assert sum(sizes) == 1000 + 1037


@pytest.mark.parametrize('file_shard', [False, True])
@pytest.mark.parametrize('shards', [2, 3])
def test_shards(file_shard, shards, tmp_path):
  paths = _write(tmp_path, n_files=4, rows=200, row_group_size=70)
  jc, tc = _configs(file_shard=file_shard)
  pattern = str(tmp_path / 'part-*.parquet')
  rows = [_same_batches(jc, tc, pattern, shard=(i, shards))
          for i in range(shards)]
  for i in range(shards):
    _same_chunks(jc, tc, pattern, 64, shard=(i, shards))
  assert sum(rows) == sum(200 + 37 * i for i in range(len(paths)))


def test_shuffled_training_batches(tmp_path):
  """mode train, shuffle on, two epochs: the same chunks, so the same
  permutations."""
  paths = _write(tmp_path, n_files=2)
  jc, tc = _configs(batch=32, shuffle=True)
  for c in (jc, tc):
    c.data_config.num_epochs = 2
  _same_batches(jc, tc, ','.join(paths), mode='train')


def test_nulls_take_the_fields_defaults(tmp_path):
  paths = _write(tmp_path)
  jc, tc = _configs()
  chunk = next(t_ip.create_reader(tc.data_config, paths[0]).chunks(1000))
  table = pq.read_table(paths[0])
  for name, dflt in (('i64', 7), ('i8', -3), ('f32', 0.5), ('flag', True),
                     ('cat', 'none')):
    nulls = np.asarray(table.column(name).is_null())
    assert nulls.any()
    assert set(chunk[name][nulls].tolist()) == {dflt}, name
  # '' takes cat's default; user has no default_val, so its '' and its
  # nulls stay
  assert '' not in chunk['cat'].tolist()
  assert '' in chunk['user'].tolist() and None in chunk['user'].tolist()
  _same_chunks(jc, tc, paths[0], 1000)


def test_list_columns(tmp_path):
  """tests/test_inputs.py's list columns: tag counts, sequence masks and
  raw vectors from Parquet list columns, in both packages alike."""
  n = 40
  rng = np.random.default_rng(0)
  labels = (rng.uniform(size=n) > 0.5).astype(np.float32)
  tags = [['t%d' % rng.integers(10) for _ in range(rng.integers(1, 4))]
          for _ in range(n)]
  seqs = [['c%d' % rng.integers(8) for _ in range(rng.integers(1, 5))]
          for _ in range(n)]
  vecs = [rng.normal(size=3).tolist() for _ in range(n)]
  path = str(tmp_path / 'd.parquet')
  pq.write_table(pa.table({
      'label': pa.array(labels),
      'tags': pa.array(tags, type=pa.list_(pa.string())),
      'seq': pa.array(seqs, type=pa.list_(pa.string())),
      'vec': pa.array(vecs, type=pa.list_(pa.float64())),
  }), path)
  text = """
data_config {
  batch_size: 16
  num_epochs: 1
  shuffle: false
  label_fields: "label"
  input_fields { input_name: "label" input_type: FLOAT }
  input_fields { input_name: "tags" input_type: STRING }
  input_fields { input_name: "seq" input_type: STRING }
  input_fields { input_name: "vec" input_type: STRING }
  input_type: ParquetInput
}
feature_config {
  features { input_names: "tags" feature_type: TagFeature
             embedding_dim: 4 hash_bucket_size: 50 max_multi_len: 4 }
  features { input_names: "seq" feature_type: SequenceFeature
             embedding_dim: 4 hash_bucket_size: 30 max_seq_len: 5 }
  features { input_names: "vec" feature_type: RawFeature
             raw_input_dim: 3 }
}
model_config { model_class: "DummyModel" }
"""
  jc = j_config.get_configs_from_pipeline_str(text)
  tc = t_config.get_configs_from_pipeline_str(text)
  pipe = t_ip.InputPipeline(tc.data_config, t_config.get_feature_configs(tc),
                            path, mode='eval')
  batch = next(iter(pipe))
  assert int(batch['feat.tags.weights'][0].sum()) == len(tags[0])
  assert int(batch['feat.seq.mask'][0].sum()) == min(len(seqs[0]), 5)
  np.testing.assert_allclose(batch['feat.vec.dense'][0], vecs[0], rtol=1e-6)
  assert _same_batches(jc, tc, path) == n


def test_missing_field_raises_as_jax(tmp_path):
  paths = _write(tmp_path)
  ivec = 'input_fields { input_name: "ivec" input_type: STRING }'
  text = (CONFIG % {'batch': 64, 'shuffle': 'false', 'file_shard': 'false',
                    'input_type': 'ParquetInput'}).replace(
      ivec, ivec + ' input_fields { input_name: "absent" '
      'input_type: STRING }')
  jc = j_config.get_configs_from_pipeline_str(text)
  tc = t_config.get_configs_from_pipeline_str(text)
  with pytest.raises(KeyError) as je:
    next(j_ip.create_reader(jc.data_config, paths[0]).chunks(100))
  with pytest.raises(KeyError) as te:
    next(t_ip.create_reader(tc.data_config, paths[0]).chunks(100))
  assert str(te.value) == str(je.value)


@pytest.mark.parametrize('codec', ['zstd', 'lz4', 'brotli'])
def test_refused_codecs_name_codec_file_and_column(codec, tmp_path):
  path = str(tmp_path / 'z.parquet')
  pq.write_table(_table(50, 1), path, compression=codec)
  _, tc = _configs()
  # pyarrow's lz4 writes LZ4_RAW, which its metadata calls LZ4
  name = {'zstd': 'ZSTD', 'lz4': 'LZ4', 'brotli': 'BROTLI'}[codec]
  assert pq.ParquetFile(path).metadata.row_group(0).column(0).compression \
      == name
  with pytest.raises(NotImplementedError) as e:
    next(t_ip.create_reader(tc.data_config, path).chunks(100))
  assert name in str(e.value) and path in str(e.value) and \
      'column label' in str(e.value)


@pytest.mark.parametrize('kind', ['int96', 'decimal', 'fixed', 'timestamp'])
def test_refused_types_name_the_column(kind, tmp_path):
  import datetime
  import decimal
  path = str(tmp_path / 't.parquet')
  col = {'int96': pa.array([datetime.datetime(2020, 1, 1)] * 3),
         'timestamp': pa.array([datetime.datetime(2020, 1, 1)] * 3),
         'decimal': pa.array([decimal.Decimal('1.5')] * 3,
                             pa.decimal128(5, 2)),
         'fixed': pa.array([b'abcd'] * 3, pa.binary(4))}[kind]
  pq.write_table(pa.table({'label': pa.array([1.0, 0.0, 1.0]), 'x': col}),
                 path, use_deprecated_int96_timestamps=kind == 'int96')
  pf = t_pq.ParquetFile(path)
  with pytest.raises(NotImplementedError, match='column x of'):
    next(pf.iter_batches(10, ['label', 'x']))
  # a column the config does not name is never decoded
  assert next(pf.iter_batches(10, ['label']))['label'][0].tolist() == \
      [1.0, 0.0, 1.0]


def test_warehouse_parquet_export(tmp_path, monkeypatch):
  """tests/test_inputs.py's warehouse case: an odps:// table resolves to
  its Parquet export and reads as the JAX package reads it; a direct path
  to the export too; no export names the workflow."""
  export = tmp_path / 'exports' / 'mytable'
  os.makedirs(export)
  n = 24
  pq.write_table(pa.table({
      'label': pa.array(np.arange(n) % 2, type=pa.float64()),
      'cat': pa.array(['c%d' % (i % 5) for i in range(n)]),
  }), str(export / 'part-0.parquet'))
  text = """
train_input_path: "odps://proj/tables/mytable"
data_config {
  batch_size: 8
  num_epochs: 1
  shuffle: false
  label_fields: "label"
  input_fields { input_name: "label" input_type: FLOAT }
  input_fields { input_name: "cat" input_type: STRING }
  input_type: OdpsInputV2
}
feature_config {
  features { input_names: "cat" feature_type: IdFeature
             embedding_dim: 4 hash_bucket_size: 50 }
}
model_config { model_class: "DummyModel" }
"""
  jc = j_config.get_configs_from_pipeline_str(text)
  tc = t_config.get_configs_from_pipeline_str(text)
  table = 'odps://proj/tables/mytable'
  monkeypatch.delenv('EASYREC_WAREHOUSE_EXPORT_DIR', raising=False)
  with pytest.raises(NotImplementedError, match='EASYREC_WAREHOUSE'):
    next(iter(t_ip.InputPipeline(tc.data_config,
                                 t_config.get_feature_configs(tc), table,
                                 mode='eval')))
  monkeypatch.setenv('EASYREC_WAREHOUSE_EXPORT_DIR',
                     str(tmp_path / 'exports'))
  assert _same_batches(jc, tc, table) == n
  monkeypatch.delenv('EASYREC_WAREHOUSE_EXPORT_DIR')
  assert _same_batches(jc, tc, str(export / '*.parquet')) == n


def test_parquet_path_fields(tmp_path):
  """parquet_train_input / parquet_eval_input are the train and eval
  paths, as in the JAX package."""
  text = """
parquet_train_input: "a.parquet"
parquet_eval_input: "b.parquet"
data_config { input_type: ParquetInput }
"""
  jc = j_config.get_configs_from_pipeline_str(text)
  tc = t_config.get_configs_from_pipeline_str(text)
  assert t_config.get_train_input_path(tc) == \
      j_config.get_train_input_path(jc) == 'a.parquet'
  assert t_config.get_eval_input_path(tc) == \
      j_config.get_eval_input_path(jc) == 'b.parquet'


def test_chip_smoke_writer_reads_back_in_both_packages(tmp_path):
  """chip_smoke.py's own Parquet writer (the card's machine has no
  pyarrow): pyarrow and the port read its files alike, nulls included,
  across its two row groups (uncompressed and snappy) and its PLAIN and
  RLE_DICTIONARY pages; its snappy blocks decompress with pyarrow's."""
  import chip_smoke
  cols = chip_smoke.criteo_day_columns(3000, 5)
  columns = chip_smoke.criteo_parquet_columns(cols) + [
      ('d', 'double', np.random.default_rng(0).normal(size=3000), None)]
  path = str(tmp_path / 'w.parquet')
  chip_smoke.write_parquet(path, columns, [(0, 1700), (1700, 3000)],
                           ['none', 'snappy'], chip_smoke.PARQUET_DICT)
  want = pq.read_table(path)
  meta = pq.ParquetFile(path).metadata
  assert meta.row_group(1).column(0).compression == 'SNAPPY'
  assert 'RLE_DICTIONARY' in meta.row_group(0).column(14).encodings
  got = next(t_pq.ParquetFile(path).iter_batches(3000, want.column_names))
  for name, _, values, nulls in columns:
    ref = [None if nulls is not None and nulls[i] else v
           for i, v in enumerate(values.tolist())]
    assert want.column(name).to_pylist() == ref, name
    vals, mask = got[name]
    assert [None if mask is not None and mask[i] else v
            for i, v in enumerate(vals.tolist())] == ref, name
  data = bytes(range(256)) * 40 + b'\x07' * 1000 + b'ab' * 3000
  assert pa.decompress(chip_smoke.snappy_compress(data), len(data),
                       codec='snappy', asbytes=True) == data


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
  """No quiet fallback to the plain versions: a source g++ refuses makes
  the decoder raise with the compiler's output, and nothing decodes."""
  bad = tmp_path / 'parquet_ops.cc'
  bad.write_text('extern "C" int pq_snappy_decompress( {\n')
  monkeypatch.setattr(po, '_SOURCE', str(bad))
  monkeypatch.setattr(po, '_lib', None)
  with pytest.raises(RuntimeError, match='building .*parquet_ops.cc failed'):
    po.native()
  with pytest.raises(RuntimeError, match='failed'):
    po.snappy_decompress(pa.compress(b'abc', codec='snappy', asbytes=True),
                         3)
