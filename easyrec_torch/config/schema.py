"""The part of the pipeline-config schema that the port reads.

A plain-Python stand-in for the protobuf messages of the JAX package
(easyrec_tpu/protos/*.proto): each message lists the fields the port
reads, with their type and proto default, so a text-format config parses
into `Message` objects that answer like the generated classes do
(defaults for unset fields, `HasField`, `WhichOneof`).

Field kinds:
  string / bool / int       scalars
  float                     proto `float`: values round to float32, as the
                            generated classes store them
  double                    proto `double`: kept as a Python float
  enum:<Enum>               enum value names, held as strings
  msg:<Message>             nested message
  unported                  a field the port does not implement: it parses,
                            and `config_util.check_ported` raises
                            NotImplementedError naming it when it is set
Fields a config sets that are not listed here are parsed and dropped. Each
of them changes nothing the port computes (reference-compat knobs, TF
runtime settings, summaries); tests/test_torch_samples.py holds every
samples/*.config to that, field by field, against the JAX package's parse.
A field that would change what the port trains is listed, as `unported`
until it is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

ENUMS: Dict[str, Tuple[str, ...]] = {
    # enum values in declaration order; numbers are not needed by the port
    'FieldType': ('INT32', 'INT64', 'STRING', 'FLOAT', 'DOUBLE', 'BOOL'),
    'InputType': ('CSVInput', 'CSVInputV2', 'CSVInputEx', 'OdpsInput',
                  'OdpsInputV2', 'DataHubInput', 'OdpsInputV3', 'RTPInput',
                  'RTPInputV2', 'OdpsRTPInput', 'OdpsRTPInputV2',
                  'TFRecordInput', 'BatchTFRecordInput', 'DummyInput',
                  'KafkaInput', 'HiveInput', 'HiveRTPInput',
                  'HiveParquetInput', 'ParquetInput', 'ParquetInputV2',
                  'ParquetInputV3', 'CriteoInput'),
    'FeatureType': ('IdFeature', 'RawFeature', 'TagFeature', 'ComboFeature',
                    'LookupFeature', 'SequenceFeature', 'ExprFeature',
                    'PassThroughFeature'),
    'WideOrDeep': ('DEEP', 'WIDE', 'WIDE_AND_DEEP'),
    'LossType': ('CLASSIFICATION', 'L2_LOSS', 'SIGMOID_L2_LOSS',
                 'CROSS_ENTROPY_LOSS', 'SOFTMAX_CROSS_ENTROPY',
                 'CIRCLE_LOSS', 'MULTI_SIMILARITY_LOSS',
                 'SOFTMAX_CROSS_ENTROPY_WITH_NEGATIVE_MINING',
                 'PAIR_WISE_LOSS', 'F1_REWEIGHTED_LOSS', 'BINARY_FOCAL_LOSS',
                 'PAIRWISE_FOCAL_LOSS', 'PAIRWISE_LOGISTIC_LOSS',
                 'PAIRWISE_HINGE_LOSS', 'JRC_LOSS', 'ORDER_CALIBRATE_LOSS',
                 'BINARY_CROSS_ENTROPY_LOSS', 'KL_DIVERGENCE_LOSS',
                 'LISTWISE_RANK_LOSS', 'LISTWISE_DISTILL_LOSS', 'ZILN_LOSS'),
}


@dataclasses.dataclass(frozen=True)
class FieldSpec:
  name: str
  kind: str
  default: Any = None
  repeated: bool = False
  oneof: Optional[str] = None

  @property
  def message_type(self) -> Optional[str]:
    return self.kind[4:] if self.kind.startswith('msg:') else None

  @property
  def enum_type(self) -> Optional[str]:
    return self.kind[5:] if self.kind.startswith('enum:') else None


def _f(name, kind, default=None, rep=False, oneof=None):
  if kind == 'float' and default is not None:
    default = float(np.float32(default))    # as the generated classes hold it
  return FieldSpec(name, kind, default, rep, oneof)


def _unported(oneof, *names):
  return [_f(n, 'unported', oneof=oneof) for n in names]


MESSAGES: Dict[str, Tuple[FieldSpec, ...]] = {
    # pipeline.proto
    'EasyRecConfig': (
        _f('train_input_path', 'string', '', oneof='train_path'),
        *_unported('train_path', 'kafka_train_input', 'datahub_train_input',
                   'hive_train_input', 'binary_train_input',
                   'parquet_train_input'),
        _f('eval_input_path', 'string', '', oneof='eval_path'),
        *_unported('eval_path', 'kafka_eval_input', 'datahub_eval_input',
                   'hive_eval_input', 'binary_eval_input',
                   'parquet_eval_input'),
        _f('model_dir', 'string', ''),
        _f('train_config', 'msg:TrainConfig'),
        _f('eval_config', 'msg:EvalConfig'),
        _f('data_config', 'msg:DatasetConfig'),
        _f('feature_configs', 'msg:FeatureConfig', rep=True),
        _f('feature_config', 'msg:FeatureConfigV2'),
        _f('model_config', 'msg:EasyRecModel'),
        _f('export_config', 'unported'),
        _f('fg_json_path', 'unported'),
    ),
    # train.proto
    'TrainConfig': (
        _f('optimizer_config', 'msg:Optimizer', rep=True),
        _f('gradient_clipping_by_norm', 'float', 0.0),
        _f('num_steps', 'int', 0),
        _f('fine_tune_checkpoint', 'string', ''),
        _f('fine_tune_ckpt_var_map', 'string', ''),
        _f('save_checkpoints_steps', 'int', 1000),
        _f('save_checkpoints_secs', 'int', 0),
        _f('keep_checkpoint_max', 'int', 10),
        _f('log_step_count_steps', 'int', 10),
        _f('force_restore_shape_compatible', 'bool', False),
        _f('freeze_gradient', 'unported', rep=True),
        _f('incr_save_config', 'unported'),
        _f('enable_oss_stop_signal', 'unported'),
        _f('dead_line', 'unported'),
        _f('compute_dtype', 'string', 'float32'),
        _f('random_seed', 'int', 2025),
    ),
    'Optimizer': (
        _f('rms_prop_optimizer', 'msg:RMSPropOptimizer', oneof='optimizer'),
        _f('momentum_optimizer', 'msg:MomentumOptimizer', oneof='optimizer'),
        _f('adam_optimizer', 'msg:AdamOptimizer', oneof='optimizer'),
        _f('momentumw_optimizer', 'msg:MomentumWOptimizer',
           oneof='optimizer'),
        _f('adamw_optimizer', 'msg:AdamWOptimizer', oneof='optimizer'),
        _f('adam_async_optimizer', 'msg:AdamAsyncOptimizer',
           oneof='optimizer'),
        _f('adagrad_optimizer', 'msg:AdagradOptimizer', oneof='optimizer'),
        _f('ftrl_optimizer', 'msg:FtrlOptimizer', oneof='optimizer'),
        _f('adam_asyncw_optimizer', 'msg:AdamAsyncWOptimizer',
           oneof='optimizer'),
        _f('lazy_adam_optimizer', 'msg:LazyAdamOptimizer',
           oneof='optimizer'),
        _f('use_moving_average', 'bool', False),
        _f('embedding_learning_rate_multiplier', 'float', 0.0),
    ),
    'RMSPropOptimizer': (
        _f('learning_rate', 'msg:LearningRate'),
        _f('momentum_optimizer_value', 'float', 0.9),
        _f('decay', 'float', 0.9),
        _f('epsilon', 'float', 1.0),
    ),
    'MomentumOptimizer': (
        _f('learning_rate', 'msg:LearningRate'),
        _f('momentum_optimizer_value', 'float', 0.9),
    ),
    'AdamOptimizer': (
        _f('learning_rate', 'msg:LearningRate'),
        _f('beta1', 'float', 0.9),
        _f('beta2', 'float', 0.999),
    ),
    'MomentumWOptimizer': (
        _f('learning_rate', 'msg:LearningRate'),
        _f('weight_decay', 'float', 1e-6),
        _f('momentum_optimizer_value', 'float', 0.9),
    ),
    'AdamWOptimizer': (
        _f('learning_rate', 'msg:LearningRate'),
        _f('weight_decay', 'float', 1e-6),
        _f('beta1', 'float', 0.9),
        _f('beta2', 'float', 0.999),
    ),
    'AdamAsyncOptimizer': (
        _f('learning_rate', 'msg:LearningRate'),
        _f('beta1', 'float', 0.9),
        _f('beta2', 'float', 0.999),
    ),
    'AdamAsyncWOptimizer': (
        _f('learning_rate', 'msg:LearningRate'),
        _f('weight_decay', 'float', 1e-6),
        _f('beta1', 'float', 0.9),
        _f('beta2', 'float', 0.999),
    ),
    'LazyAdamOptimizer': (
        _f('learning_rate', 'msg:LearningRate'),
        _f('beta1', 'float', 0.9),
        _f('beta2', 'float', 0.999),
    ),
    'AdagradOptimizer': (
        _f('learning_rate', 'msg:LearningRate'),
        _f('initial_accumulator_value', 'float', 0.1),
    ),
    'FtrlOptimizer': (
        _f('learning_rate', 'msg:LearningRate'),
        _f('learning_rate_power', 'float', -0.5),
        _f('initial_accumulator_value', 'float', 0.1),
        _f('l1_reg', 'float', 0.0),
        _f('l2_reg', 'float', 0.0),
        _f('l2_shrinkage_reg', 'float', 0.0),
    ),
    'LearningRate': (
        _f('constant_learning_rate', 'msg:ConstantLearningRate',
           oneof='learning_rate'),
        _f('exponential_decay_learning_rate',
           'msg:ExponentialDecayLearningRate', oneof='learning_rate'),
        *_unported('learning_rate', 'manual_step_learning_rate',
                   'cosine_decay_learning_rate', 'poly_decay_learning_rate',
                   'transformer_learning_rate'),
    ),
    'ConstantLearningRate': (
        _f('learning_rate', 'float', 0.002),
    ),
    'ExponentialDecayLearningRate': (
        _f('initial_learning_rate', 'float', 0.002),
        _f('decay_steps', 'int', 4000000),
        _f('decay_factor', 'float', 0.95),
        _f('staircase', 'bool', True),
        _f('burnin_learning_rate', 'float', 0.0),
        _f('burnin_steps', 'int', 0),
        _f('min_learning_rate', 'float', 0.0),
    ),
    # models.proto
    'EvalConfig': (
        _f('num_examples', 'int', 0),
        _f('metrics_set', 'msg:EvalMetrics', rep=True),
        _f('eval_online', 'unported'),
    ),
    'EvalMetrics': (
        _f('auc', 'msg:AUC', oneof='metric'),
        *_unported('metric', 'recall_at_topk', 'mean_absolute_error',
                   'mean_squared_error', 'accuracy', 'max_f1',
                   'root_mean_squared_error', 'gauc', 'session_auc',
                   'recall', 'precision', 'precision_at_topk'),
    ),
    'AUC': (
        _f('num_thresholds', 'int', 200),
    ),
    'EasyRecModel': (
        _f('model_class', 'string', ''),
        _f('feature_groups', 'msg:FeatureGroupConfig', rep=True),
        _f('deepfm', 'msg:DeepFM', oneof='model'),
        _f('multi_tower', 'msg:MultiTower', oneof='model'),
        *_unported('model', 'model_params', 'dummy', 'wide_and_deep',
                   'fm', 'dcn', 'autoint', 'dlrm', 'cmbf',
                   'uniter', 'multi_tower_recall', 'dssm', 'mind',
                   'dropoutnet', 'metric_learning', 'pdn', 'dssm_senet',
                   'dat', 'mmoe', 'esmm', 'dbmtl', 'simple_multi_task',
                   'ple', 'rocket_launching'),
        _f('seq_att_groups', 'msg:SeqAttGroupConfig', rep=True),
        _f('embedding_regularization', 'float', 0.0),
        _f('loss_type', 'enum:LossType', 'CLASSIFICATION'),
        _f('num_class', 'int', 1),
        _f('ev_params', 'msg:EVParams'),
        _f('kd', 'unported', rep=True),
        _f('restore_filters', 'string', rep=True),
        _f('loss_weight_strategy', 'unported'),
        _f('variational_dropout', 'unported'),
        _f('losses', 'unported', rep=True),
        _f('backbone', 'unported'),
        _f('label_name', 'string', ''),
    ),
    'DeepFM': (
        _f('dnn', 'msg:DNN'),
        _f('final_dnn', 'msg:DNN'),
        _f('wide_output_dim', 'int', 1),
        _f('l2_regularization', 'float', 1e-4),
    ),
    'MultiTower': (
        _f('towers', 'msg:Tower', rep=True),
        _f('final_dnn', 'msg:DNN'),
        _f('l2_regularization', 'float', 1e-4),
        _f('din_towers', 'msg:DINTower', rep=True),
        _f('bst_towers', 'unported', rep=True),
    ),
    'DINTower': (
        _f('input', 'string', ''),
        _f('dnn', 'msg:DNN'),
    ),
    # common.proto
    'Tower': (
        _f('input', 'string', ''),
        _f('dnn', 'msg:DNN'),
    ),
    'DNN': (
        _f('hidden_units', 'int', rep=True),
        _f('dropout_ratio', 'float', rep=True),
        _f('activation', 'string', 'tf.nn.relu'),
        _f('use_bn', 'bool', True),
    ),
    'Initializer': (
        _f('truncated_normal_initializer', 'msg:TruncatedNormalInitializer',
           oneof='initializer_oneof'),
        _f('random_normal_initializer', 'msg:RandomNormalInitializer',
           oneof='initializer_oneof'),
        _f('glorot_normal_initializer', 'msg:GlorotNormalInitializer',
           oneof='initializer_oneof'),
        _f('constant_initializer', 'msg:ConstantInitializer',
           oneof='initializer_oneof'),
    ),
    'TruncatedNormalInitializer': (
        _f('mean', 'float', 0.0),
        _f('stddev', 'float', 1.0),
    ),
    'RandomNormalInitializer': (
        _f('mean', 'float', 0.0),
        _f('stddev', 'float', 1.0),
    ),
    'GlorotNormalInitializer': (),
    'ConstantInitializer': (
        _f('consts', 'float', rep=True),
    ),
    # data.proto
    'DatasetConfig': (
        _f('batch_size', 'int', 32),
        _f('auto_expand_input_fields', 'bool', False),
        _f('label_fields', 'string', rep=True),
        _f('extra_label_func', 'unported', rep=True),
        _f('shuffle', 'bool', True),
        _f('shuffle_buffer_size', 'int', 32),
        _f('num_epochs', 'int', 0),
        _f('input_type', 'enum:InputType', 'CSVInput'),
        _f('separator', 'string', ','),
        _f('input_fields', 'msg:Field', rep=True),
        _f('ignore_error', 'bool', False),
        _f('sample_weight', 'string', ''),
        _f('with_header', 'bool', False),
        *_unported('sampler', 'negative_sampler', 'negative_sampler_v2',
                   'hard_negative_sampler', 'hard_negative_sampler_v2',
                   'negative_sampler_in_memory'),
        _f('eval_batch_size', 'int', 4096),
        _f('drop_remainder', 'bool', False),
        _f('max_tag_len', 'int', 16),
    ),
    'Field': (
        _f('input_name', 'string', ''),
        _f('input_type', 'enum:FieldType', 'STRING'),
        _f('default_val', 'string', ''),
        _f('user_define_fn', 'unported'),
    ),
    'FeatureConfig': (
        _f('feature_name', 'string', ''),
        _f('input_names', 'string', rep=True),
        _f('feature_type', 'enum:FeatureType', 'IdFeature'),
        _f('embedding_name', 'string', ''),
        _f('embedding_dim', 'int', 0),
        _f('hash_bucket_size', 'int', 0),
        _f('num_buckets', 'int', 0),
        _f('boundaries', 'double', rep=True),
        _f('separator', 'string', '|'),
        _f('vocab_file', 'string', ''),
        _f('vocab_list', 'string', rep=True),
        _f('shared_names', 'string', rep=True),
        _f('combiner', 'string', 'sum'),
        _f('initializer', 'msg:Initializer'),
        _f('min_val', 'double', 0.0),
        _f('max_val', 'double', 0.0),
        _f('normalizer_fn', 'string', ''),
        _f('raw_input_dim', 'int', 1),
        _f('ev_params', 'msg:EVParams'),
        _f('max_multi_len', 'int', 0),
        _f('max_seq_len', 'int', 0),
        _f('sub_feature_type', 'enum:FeatureType', 'IdFeature'),
        _f('kv_separator', 'unported'),
        _f('expression', 'unported'),
        _f('combo_input_seps', 'unported', rep=True),
        _f('sequence_combiner', 'unported'),
    ),
    'EVParams': (
        # use_cache, init_capacity and max_capacity size the reference's
        # growing KV store; static hash tables have none (features/ev.py)
        _f('filter_freq', 'int', 0),
        _f('steps_to_live', 'int', 0),
    ),
    'FeatureConfigV2': (
        _f('features', 'msg:FeatureConfig', rep=True),
    ),
    'FeatureGroupConfig': (
        _f('group_name', 'string', ''),
        _f('feature_names', 'string', rep=True),
        _f('wide_deep', 'enum:WideOrDeep', 'DEEP'),
        _f('sequence_features', 'unported', rep=True),
    ),
    'SeqAttGroupConfig': (
        _f('group_name', 'string', ''),
        _f('seq_att_map', 'msg:SeqAttMap', rep=True),
        _f('seq_dnn', 'unported'),
        _f('need_key_feature', 'bool', True),
        _f('allow_key_transform', 'bool', False),
    ),
    'SeqAttMap': (
        _f('key', 'string', rep=True),
        _f('hist_seq', 'string', rep=True),
        _f('aux_hist_seq', 'unported', rep=True),
    ),
}

_INDEX: Dict[str, Dict[str, FieldSpec]] = {
    m: {f.name: f for f in fields} for m, fields in MESSAGES.items()}


def field(message: str, name: str) -> FieldSpec:
  """The FieldSpec of `message.name`; AttributeError for unknown names."""
  try:
    return _INDEX[message][name]
  except KeyError:
    raise AttributeError('%s has no field %r in the port\'s schema'
                         % (message, name)) from None


def has_field(message: str, name: str) -> bool:
  return name in _INDEX[message]
