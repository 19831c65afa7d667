"""The remaining feature types of the port (ComboFeature, LookupFeature,
ExprFeature, PassThroughFeature), its text functions and the ExprFeature
DSL, against the JAX package on the CPU: one config
parsed by both packages, the same numpy columns made from a seed through
both packages' specs and transforms. Ids must be equal, floats bit-equal.
The port's native text functions are held against the JAX package's and
against the port's own plain Python versions, exactly."""

import numpy as np
import pytest

from easyrec_torch.config import config_util as t_config
from easyrec_torch.features import feature_spec as t_fs
from easyrec_torch.features import transforms as t_tr
from easyrec_torch.ops import text_ops as t_text
from easyrec_torch.utils import expr as t_expr
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.features import feature_spec as j_fs
from easyrec_tpu.features import transforms as j_tr
from easyrec_tpu.ops import text_ops as j_text
from easyrec_tpu.utils import expr as j_expr

N = 97

WORDS = ['red', 'Blue', 'shoe', 'SHOE', 'bag', 'x', 'tea,cup', 'café',
         'naïve', '日本', 'a.b', 'red!']


def columns(seed=7, n=N):
  """Raw columns of every input the configs below read."""
  rng = np.random.default_rng(seed)

  def text(lo, hi):
    return np.array([' '.join(rng.choice(WORDS, rng.integers(lo, hi)))
                     for _ in range(n)], dtype=object)

  cates = ['c%d' % c for c in range(6)]
  maps = []
  for _ in range(n):
    k = rng.integers(0, 6)
    maps.append('|'.join('%s:%s' % (rng.choice(cates),
                                    rng.choice(['0.5', '1.25', '3', 'x',
                                                '-2', '7.5']))
                         for _ in range(k)))
  cols = {
      'uid': np.array(['u%d' % v for v in rng.integers(0, 40, n)],
                      dtype=object),
      'cate': np.array([rng.choice(cates) for _ in range(n)], dtype=object),
      'tags': np.array(['|'.join('t%d' % t for t in
                                 rng.integers(0, 9, rng.integers(0, 4)))
                        for _ in range(n)], dtype=object),
      'age': rng.random(n),
      'price': rng.random(n) * 100.0,
      'kvmap': np.array(maps, dtype=object),
      'query': text(0, 5),
      'title': text(1, 80),
      'wmap': np.array([','.join('%s:%g' % (w, rng.integers(1, 5))
                                 for w in rng.choice(WORDS[:6], 3))
                        for _ in range(n)], dtype=object),
      'wkeys': np.array([','.join(rng.choice(WORDS[:6], 2))
                         for _ in range(n)], dtype=object),
  }
  cols['tags'][3] = ''
  cols['kvmap'][5] = ''
  cols['query'][2] = 'x' * 300
  cols['title'][2] = 'y' * 290 + 'x'
  return cols


FEATURES = r'''
feature_config {
  features { feature_name: "combo" input_names: "uid" input_names: "cate"
             feature_type: ComboFeature hash_bucket_size: 1000
             embedding_dim: 4 }
  features { feature_name: "combo_seps" input_names: "uid"
             input_names: "tags" feature_type: ComboFeature
             hash_bucket_size: 500 embedding_dim: 4
             combo_input_seps: "" combo_input_seps: "|" max_multi_len: 3 }
  features { feature_name: "combo_join" input_names: "cate"
             input_names: "tags" feature_type: ComboFeature
             hash_bucket_size: 300 embedding_dim: 4 combo_join_sep: "#"
             combo_input_seps: "" combo_input_seps: "|" }
  features { feature_name: "combo_vocab" input_names: "cate"
             input_names: "cate" feature_type: ComboFeature
             combo_join_sep: "_" vocab_list: "c1_c1" vocab_list: "c2_c2"
             embedding_dim: 4 }
  features { feature_name: "lk_hash" input_names: "cate"
             input_names: "kvmap" feature_type: LookupFeature
             hash_bucket_size: 100 embedding_dim: 4 }
  features { feature_name: "lk_hash_sel" input_names: "cate"
             input_names: "kvmap" feature_type: LookupFeature
             hash_bucket_size: 100 embedding_dim: 4
             lookup_max_sel_elem_num: 3 }
  features { feature_name: "lk_dense_sel" input_names: "cate"
             input_names: "kvmap" feature_type: LookupFeature
             lookup_max_sel_elem_num: 3 }
  features { feature_name: "lk_proj_sel" input_names: "cate"
             input_names: "kvmap" feature_type: LookupFeature
             lookup_max_sel_elem_num: 2 embedding_dim: 4 }
  features { feature_name: "lk_bounds_sel" input_names: "cate"
             input_names: "kvmap" feature_type: LookupFeature
             lookup_max_sel_elem_num: 2 boundaries: [0.0, 1.0, 5.0]
             embedding_dim: 4 }
  features { feature_name: "lk_unset" input_names: "cate"
             input_names: "kvmap" feature_type: LookupFeature }
  features { feature_name: "lk_unset_emb" input_names: "cate"
             input_names: "kvmap" feature_type: LookupFeature
             embedding_dim: 4 }
  features { feature_name: "ex_arith" input_names: "age"
             input_names: "price" feature_type: ExprFeature
             expression: "(age + 1.0) * price" }
  features { feature_name: "ex_funcs" input_names: "age"
             input_names: "price" feature_type: ExprFeature
             expression: "log1p(price) - sigmoid(age) + min(age, 0.5) ** 2 + (age if age > 0.3 else -age) + abs(age - 0.5) // 0.1 + sqrt(price) % 3"
             embedding_dim: 4 }
  features { feature_name: "ex_cmp" input_names: "age"
             feature_type: ExprFeature expression: "age >= 0.5" }
  features { feature_name: "ex_qcr" input_names: "query"
             input_names: "title" feature_type: ExprFeature
             expression: "query_common_ratio(query, title)" }
  features { feature_name: "ex_tcr" input_names: "query"
             input_names: "title" feature_type: ExprFeature
             expression: "title_common_ratio(query, title) + is_contain(query, title)" }
  features { feature_name: "ex_cw" input_names: "query"
             input_names: "title" feature_type: ExprFeature
             expression: "common_word(query, title) * 2 + text_len(query)" }
  features { feature_name: "ex_ed" input_names: "query"
             input_names: "title" feature_type: ExprFeature
             expression: "edit_distance(query, title)" embedding_dim: 4 }
  features { feature_name: "ex_mdp" input_names: "wmap"
             input_names: "wkeys" feature_type: ExprFeature
             expression: "mapped_dot_product(wmap, wkeys)" }
  features { feature_name: "pass_age" input_names: "age"
             feature_type: PassThroughFeature }
  features { feature_name: "pass_price" input_names: "price"
             feature_type: PassThroughFeature }
}
'''


def _features(text=FEATURES):
  t = t_config.get_configs_from_pipeline_str(text)
  j = j_config.get_configs_from_pipeline_str(text)
  return (t_config.get_feature_configs(t), j_config.get_feature_configs(j))


def _same(a, b, what):
  a, b = np.asarray(a), np.asarray(b)
  assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                     a.shape, b.shape)
  assert a.tobytes() == b.tobytes(), (what, a, b)


def test_specs_match_jax():
  t_fcs, j_fcs = _features()
  t_specs = t_fs.build_feature_specs(t_fcs)
  j_specs = j_fs.build_feature_specs(j_fcs)
  assert list(t_specs) == list(j_specs)
  for name, js in j_specs.items():
    ts = t_specs[name]
    for f in ('kind', 'num_ids', 'table_name', 'rows', 'embedding_dim',
              'combiner', 'value_dim', 'is_weighted', 'seq_is_dense'):
      assert getattr(ts, f) == getattr(js, f), (name, f)
  # the kv-map lookup applies only where lookup_max_sel_elem_num is set,
  # though it reads 10 unset (data.proto's default)
  assert t_fcs[9].lookup_max_sel_elem_num == 10
  assert not t_fcs[9].HasField('lookup_max_sel_elem_num')
  assert t_specs['lk_unset'].kind == 'dense'
  assert t_specs['lk_unset'].value_dim == 1
  assert t_specs['lk_dense_sel'].value_dim == 3
  assert t_specs['combo_seps'].num_ids == 3
  assert t_specs['combo_join'].num_ids == 8


@pytest.mark.parametrize('seed', [7, 8])
def test_transforms_match_jax(seed):
  t_fcs, j_fcs = _features()
  t_specs = t_fs.build_feature_specs(t_fcs)
  j_specs = j_fs.build_feature_specs(j_fcs)
  cols = columns(seed)
  for name in j_specs:
    t_out = t_tr.build_transform(t_specs[name])(dict(cols))
    j_out = j_tr.build_transform(j_specs[name])(dict(cols))
    assert sorted(t_out) == sorted(j_out), name
    for k in j_out:
      _same(t_out[k], j_out[k], k)


def test_combo_crosses_and_lookup_selects():
  """What the transforms compute, beside the JAX package's numbers: the
  row-wise cross of combo_input_seps (empty tags keep the row's one
  cross), the joined vocab combo, and the map values of the row's key."""
  t_fcs, _ = _features()
  specs = t_fs.build_feature_specs(t_fcs)
  cols = {'uid': np.array(['u1', 'u2', 'u3'], dtype=object),
          'cate': np.array(['c1', 'c2', 'c9'], dtype=object),
          'tags': np.array(['a|b|c|d', '', 'e'], dtype=object),
          'kvmap': np.array(['c1:1.5|c2:2|c1:x|c1:4', 'c1:9', ''],
                            dtype=object)}
  out = t_tr.build_transform(specs['combo_seps'])(cols)
  np.testing.assert_array_equal(out['feat.combo_seps.weights'],
                                [[1, 1, 1], [1, 0, 0], [1, 0, 0]])
  from easyrec_torch.ops import hashing
  want = hashing.hash_strings(np.array(['u1\x1da', 'u1\x1db', 'u1\x1dc'],
                                       dtype=object), 500)
  np.testing.assert_array_equal(out['feat.combo_seps.ids'][0], want)
  out = t_tr.build_transform(specs['combo_vocab'])(cols)
  np.testing.assert_array_equal(out['feat.combo_vocab.ids'][:, 0],
                                [0, 1, 2])
  out = t_tr.build_transform(specs['lk_dense_sel'])(cols)
  np.testing.assert_array_equal(out['feat.lk_dense_sel.dense'],
                                np.float32([[1.5, 0, 4], [0, 0, 0],
                                            [0, 0, 0]]))
  out = t_tr.build_transform(specs['lk_proj_sel'])(cols)
  np.testing.assert_array_equal(out['feat.lk_proj_sel.weights'],
                                np.float32([[1.5, 0], [0, 0], [0, 0]]))
  np.testing.assert_array_equal(out['feat.lk_proj_sel.ids'],
                                [[0, 1]] * 3)


def test_expr_evaluates_as_jax():
  """The DSL itself, port against JAX: values and dtypes of arithmetic
  over f64 and f32 arrays, and its refusals."""
  rng = np.random.default_rng(3)
  variables = {'a': rng.random(20), 'b': rng.random(20).astype(np.float32)}
  for expression in ('a * b + 1', 'max(a, b) - exp(b)', '-a / (b + 1)',
                     'floor(a * 10) + ceil(b) + sign(a - 0.5)',
                     'log(a + 1) if a < b else b', 'a != b', '+a ** 2'):
    got = t_expr.evaluate(expression, variables)
    want = j_expr.evaluate(expression, variables)
    _same(got, want, expression)
  for bad in ('__import__("os")', 'a.real', '[a]', 'a and b',
              'a < b < 1', 'unknown(a)'):
    with pytest.raises((ValueError, KeyError)):
      t_expr.evaluate(bad, variables)
  with pytest.raises(KeyError):
    t_expr.evaluate('zz + 1', variables)


TEXT_A = ['Red shoe, BLUE bag!', 'café au lait', '', 'x' * 300,
          ' '.join('w%d' % i for i in range(80)), 'a  b   a', '日本 語 日本',
          'Tab\there', 'naïve NAÏVE']
TEXT_B = ['red shoe bag', 'lait café', 'empty', 'x' * 299 + 'y',
          ' '.join('w%d' % i for i in range(70, 90)), 'a b', '日本',
          'tab here', 'naïve']


def test_native_text_functions_match_jax_and_plain():
  a = np.array(TEXT_A, dtype=object)
  b = np.array(TEXT_B, dtype=object)
  for got, plain, want in (
      (t_text.text_normalize(a), t_text.plain_text_normalize(a),
       j_text.text_normalize(a)),
      (t_text.edit_distance(a, b), t_text.plain_edit_distance(a, b),
       j_text.edit_distance(a, b))):
    assert list(got) == list(plain) == list(want)
  for sep in (' ', ','):
    got = t_text.overlap_counts(a, b, sep)
    plain = t_text.plain_overlap_counts(a, b, sep)
    want = j_text._overlap_counts(a, b, sep)
    for g, p, w in zip(got, plain, want):
      _same(g, p, sep)
      _same(g, w, sep)
  # the first 64 terms of a count, every term of b
  assert t_text.overlap_counts(a[4:5], b[4:5])[0][0] == 0
  assert t_text.overlap_counts(a[4:5], a[4:5])[1][0] == 64
  for fn in ('query_common_ratio', 'title_common_ratio', 'is_contain',
             'common_word'):
    _same(getattr(t_text, fn)(a, b), getattr(j_text, fn)(a, b), fn)
  _same(t_text.mapped_dot_product(np.array(['a:1,b:2.5,c:x', ''], object),
                                  np.array(['b,a,z', 'a'], object)),
        j_text.mapped_dot_product(np.array(['a:1,b:2.5,c:x', ''], object),
                                  np.array(['b,a,z', 'a'], object)), 'mdp')
  with pytest.raises(ValueError):
    t_text.overlap_counts(a, b, '||')


def test_native_text_functions_on_random_bytes():
  """Random strings over a small alphabet with multibyte characters and
  separators, native against plain, exactly."""
  rng = np.random.default_rng(11)
  alphabet = list('abAB ,.!') + ['é', '日', '\t']
  a = np.array([''.join(rng.choice(alphabet, rng.integers(0, 300)))
                for _ in range(64)], dtype=object)
  b = np.array([''.join(rng.choice(alphabet, rng.integers(0, 40)))
                for _ in range(64)], dtype=object)
  assert list(t_text.text_normalize(a)) == \
      list(t_text.plain_text_normalize(a))
  _same(t_text.edit_distance(a, b), t_text.plain_edit_distance(a, b), 'ed')
  for g, p in zip(t_text.overlap_counts(a, b, ' '),
                  t_text.plain_overlap_counts(a, b, ' ')):
    _same(g, p, 'overlap')
