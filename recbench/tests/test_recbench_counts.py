"""The FLOP and byte counters against counts worked by hand for one small
shape, and the traffic generator's sizes."""

import torch

from recbench import counts, traffic
from recbench.cell import load_cell
from recbench.reference import deepfm_criteo, din_taobao
from recbench.tests.small import SMALL


def test_deepfm_flops_by_hand():
  model = {'features': [{'name': 'F1', 'kind': 'raw', 'rows': 1, 'dim': 4,
                         'wide_dim': 1},
                        {'name': 'F2', 'kind': 'raw', 'rows': 1, 'dim': 4,
                         'wide_dim': 1},
                        {'name': 'C1', 'kind': 'id', 'rows': 10, 'dim': 4,
                         'wide_dim': 1}],
           'dnn': [8], 'final_dnn': [4]}
  # dnn 12 -> 8: 2*12*8 = 192; final 1 + 4 + 8 = 13 -> 4 -> 1: 2*13*4 +
  # 2*4*1 = 112; FM over 3 fields of 4: 3*3*4 = 36
  assert deepfm_criteo.flops_per_example(model) == 192 + 112 + 36


def test_din_flops_by_hand():
  model = {'features': [{'name': 'u', 'kind': 'id', 'rows': 5, 'dim': 2},
                        {'name': 'k', 'kind': 'id', 'rows': 5, 'dim': 2},
                        {'name': 'h', 'kind': 'seq', 'rows': 5, 'dim': 2,
                         'max_len': 3}],
           'towers': {'user': ['u'], 'item': ['k']}, 'tower_dnn': [4],
           'din': {'keys': ['k'], 'hists': ['h'], 'att_dnn': [3, 1]},
           'final_dnn': [2]}
  towers = 2 * (2 * 2 * 4)                       # two towers 2 -> 4
  attention = 3 * (2 * 8 * 3 + 2 * 3 * 1 + 4 * 2)  # each of 3 positions
  final = 2 * (4 + 4 + 2 + 2) * 2 + 2 * 2 * 1    # 12 -> 2 -> 1
  assert din_taobao.flops_per_example(model) == towers + attention + final


def test_sparse_update_bytes_by_hand():
  # an int32 id and the f32 gradient of 16 deep and 1 wide column: 4 + 68;
  # the table's padding to 32 columns is not the function's
  assert counts.slot_bytes(4, {'dim': 16, 'wide_dim': 1}) == 72
  assert counts.slot_bytes(8, {'dim': 16}) == 72
  # 720 bytes of slots; 4 rows of 4 f32 read and written
  assert counts.sparse_update_bytes(
      720, 4, {'weight_dim': 2, 'row_floats': 4}) == 720 + 2 * 4 * 16
  assert counts.train_flops(100.0, 8) == 2400.0


def test_slot_counts_and_seeded_batches(root):
  cell = load_cell('din_taobao.hist50_b65536', root, SMALL)
  feats = cell.features()
  a = traffic.make_batch(feats, cell.traffic, 2 ** 31 + 9, 0, 'cpu')
  b = traffic.make_batch(feats, cell.traffic, 2 ** 31 + 9, 0, 'cpu')
  c = traffic.make_batch(feats, cell.traffic, 2 ** 31 + 10, 0, 'cpu')
  assert all(torch.equal(a[k], b[k]) for k in a)
  assert any(not torch.equal(a[k], c[k]) for k in a)
  assert {k: v.shape for k, v in a.items()} == \
      {k: v.shape for k, v in c.items()}
  n = traffic.slot_counts(feats, a)
  assert n['slots'] == 64 * (15 + 2 * 50)
  # int32 ids and 16 f32 gradient columns a slot
  assert a['feat.brand.ids'].dtype == torch.int32
  assert n['slot_bytes'] == n['slots'] * (4 + 4 * 16)
  assert 0 < n['rows'] <= n['slots']
  # one history length a row, shared by the two histories
  assert torch.equal(a['feat.tag_brand_list.mask'],
                     a['feat.tag_category_list.mask'])
  lengths = a['feat.tag_brand_list.mask'].sum(1)
  assert lengths.min() >= 1 and lengths.max() <= 50


def test_power_law_ids_stay_in_range():
  gen = traffic.generator(3, 'x', device='cpu')
  ids = traffic.power_law_ids(gen, (10000,), 10131227, 1.1, 1000, 2654435761)
  assert ids.min() >= 0 and ids.max() < 1000
  # the hottest rank takes a large share, as a power law does
  assert torch.bincount(ids).max() > 500
