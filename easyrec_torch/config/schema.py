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
    'LossWeightStrategy': ('Fixed', 'Uncertainty', 'Random'),
    'Similarity': ('COSINE', 'INNER_PRODUCT', 'EUCLID'),
    'UserSeqCombineMethod': ('CONCAT', 'SUM'),
    'NullValue': ('NULL_VALUE',),
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
        _f('export_config', 'msg:ExportConfig'),
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
        _f('enable_oss_stop_signal', 'bool', False),
        _f('dead_line', 'string', ''),
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
        _f('moving_average_decay', 'float', 0.9999),
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
    # export_config: the exporter, best-export metric and early stop, and
    # the serving outputs; the TF placeholder knobs (batch_size,
    # multi_placeholder, filter_inputs, placeholder_named_by_input,
    # multi_value_fields, auto_multi_value) change nothing in either
    # package and are not listed
    'ExportConfig': (
        _f('exporter_type', 'string', 'final'),
        _f('best_exporter_metric', 'string', 'auc'),
        _f('metric_bigger', 'bool', True),
        _f('enable_early_stop', 'bool', False),
        _f('early_stop_func', 'string', ''),
        _f('early_stop_params', 'string', ''),
        _f('max_check_steps', 'int', 10000),
        _f('exports_to_keep', 'int', 1),
        _f('export_features', 'bool', False),
        _f('export_rtp_outputs', 'bool', False),
        _f('asset_files', 'string', rep=True),
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
        _f('eval_online', 'bool', False),
    ),
    'EvalMetrics': (
        _f('auc', 'msg:AUC', oneof='metric'),
        _f('max_f1', 'msg:Max_F1', oneof='metric'),
        _f('recall_at_topk', 'msg:RecallAtTopK', oneof='metric'),
        _f('mean_absolute_error', 'msg:MeanAbsoluteError', oneof='metric'),
        _f('mean_squared_error', 'msg:MeanSquaredError', oneof='metric'),
        _f('root_mean_squared_error', 'msg:RootMeanSquaredError',
           oneof='metric'),
        _f('precision_at_topk', 'msg:AvgPrecisionAtTopK', oneof='metric'),
        *_unported('metric', 'accuracy', 'gauc', 'session_auc', 'recall',
                   'precision'),
    ),
    'AUC': (
        _f('num_thresholds', 'int', 200),
    ),
    'Max_F1': (),
    'RecallAtTopK': (
        _f('topk', 'int', 5),
    ),
    'AvgPrecisionAtTopK': (
        _f('topk', 'int', 5),
    ),
    'MeanAbsoluteError': (),
    'MeanSquaredError': (),
    'RootMeanSquaredError': (),
    'EasyRecModel': (
        _f('model_class', 'string', ''),
        _f('feature_groups', 'msg:FeatureGroupConfig', rep=True),
        _f('deepfm', 'msg:DeepFM', oneof='model'),
        _f('multi_tower', 'msg:MultiTower', oneof='model'),
        _f('mmoe', 'msg:MMoE', oneof='model'),
        _f('esmm', 'msg:ESMM', oneof='model'),
        _f('dbmtl', 'msg:DBMTL', oneof='model'),
        _f('simple_multi_task', 'msg:SimpleMultiTask', oneof='model'),
        _f('ple', 'msg:PLE', oneof='model'),
        _f('wide_and_deep', 'msg:WideAndDeep', oneof='model'),
        _f('fm', 'msg:FMModel', oneof='model'),
        _f('dcn', 'msg:DCN', oneof='model'),
        _f('autoint', 'msg:AutoInt', oneof='model'),
        _f('dlrm', 'msg:DLRM', oneof='model'),
        _f('rocket_launching', 'msg:RocketLaunching', oneof='model'),
        _f('model_params', 'msg:ModelParams', oneof='model'),
        _f('multi_tower_recall', 'msg:MultiTowerRecall', oneof='model'),
        _f('dssm', 'msg:DSSM', oneof='model'),
        _f('mind', 'msg:MIND', oneof='model'),
        _f('dropoutnet', 'msg:DropoutNet', oneof='model'),
        _f('metric_learning', 'msg:CoMetricLearningI2I', oneof='model'),
        _f('pdn', 'msg:PDN', oneof='model'),
        _f('dssm_senet', 'msg:DSSM_SENet', oneof='model'),
        _f('dat', 'msg:DAT', oneof='model'),
        *_unported('model', 'dummy', 'cmbf', 'uniter'),
        _f('seq_att_groups', 'msg:SeqAttGroupConfig', rep=True),
        _f('embedding_regularization', 'float', 0.0),
        _f('loss_type', 'enum:LossType', 'CLASSIFICATION'),
        _f('num_class', 'int', 1),
        _f('ev_params', 'msg:EVParams'),
        _f('kd', 'msg:KD', rep=True),
        _f('restore_filters', 'string', rep=True),
        _f('loss_weight_strategy', 'enum:LossWeightStrategy', 'Fixed'),
        _f('variational_dropout', 'msg:VariationalDropoutLayer'),
        _f('losses', 'msg:Loss', rep=True),
        _f('backbone', 'msg:BackboneTower'),
        _f('label_name', 'string', ''),
    ),
    'DeepFM': (
        _f('dnn', 'msg:DNN'),
        _f('final_dnn', 'msg:DNN'),
        _f('wide_output_dim', 'int', 1),
        _f('l2_regularization', 'float', 1e-4),
    ),
    'WideAndDeep': (
        _f('wide_output_dim', 'int', 1),
        _f('dnn', 'msg:DNN'),
        _f('final_dnn', 'msg:DNN'),
        _f('l2_regularization', 'float', 1e-4),
    ),
    'FMModel': (
        # use_variant is read by neither package's FM model
        _f('use_variant', 'bool', False),
        _f('l2_regularization', 'float', 1e-4),
    ),
    'CrossTower': (
        _f('input', 'string', ''),
        _f('cross_num', 'int', 3),
    ),
    'DCN': (
        _f('deep_tower', 'msg:Tower'),
        _f('cross_tower', 'msg:CrossTower'),
        _f('final_dnn', 'msg:DNN'),
        _f('l2_regularization', 'float', 1e-4),
    ),
    'AutoInt': (
        _f('multi_head_num', 'int', 1),
        _f('multi_head_size', 'int', 0),
        _f('interacting_layer_num', 'int', 1),
        _f('l2_regularization', 'float', 1e-4),
    ),
    'DLRM': (
        _f('top_dnn', 'msg:DNN'),
        _f('bot_dnn', 'msg:DNN'),
        _f('arch_interaction_op', 'string', 'dot'),
        _f('arch_interaction_itself', 'bool', False),
        _f('arch_with_dense_feature', 'bool', False),
        _f('l2_regularization', 'float', 1e-5),
    ),
    'RocketLaunching': (
        _f('share_dnn', 'msg:DNN'),
        _f('booster_dnn', 'msg:DNN'),
        _f('light_dnn', 'msg:DNN'),
        _f('l2_regularization', 'float', 1e-4),
        _f('feature_based_distillation', 'bool', False),
        _f('feature_distillation_function', 'enum:Similarity', 'COSINE'),
    ),
    'MultiTower': (
        _f('towers', 'msg:Tower', rep=True),
        _f('final_dnn', 'msg:DNN'),
        _f('l2_regularization', 'float', 1e-4),
        _f('din_towers', 'msg:DINTower', rep=True),
        _f('bst_towers', 'msg:BSTTower', rep=True),
    ),
    'BSTTower': (
        _f('input', 'string', ''),
        _f('seq_len', 'int', 5),
        _f('multi_head_size', 'int', 4),
        _f('pre_ln', 'bool', False),
    ),
    'DINTower': (
        _f('input', 'string', ''),
        _f('dnn', 'msg:DNN'),
    ),
    # the multi-task family; the JAX MMoE message has no
    # loss_weight_strategy, so a config's mmoe.loss_weight_strategy is
    # dropped by both packages' parsers
    'ExpertTower': (
        _f('expert_name', 'string', ''),
        _f('dnn', 'msg:DNN'),
    ),
    'MMoE': (
        _f('experts', 'msg:ExpertTower', rep=True),
        _f('expert_dnn', 'msg:DNN'),
        _f('num_expert', 'int', 0),
        _f('task_towers', 'msg:TaskTower', rep=True),
        _f('l2_regularization', 'float', 1e-4),
    ),
    'ESMM': (
        _f('groups', 'msg:Tower', rep=True),
        _f('ctr_tower', 'msg:TaskTower'),
        _f('cvr_tower', 'msg:TaskTower'),
        _f('l2_regularization', 'float', 1e-4),
    ),
    'DBMTL': (
        _f('bottom_cmbf', 'unported'),
        _f('bottom_uniter', 'unported'),
        _f('bottom_dnn', 'msg:DNN'),
        _f('expert_dnn', 'msg:DNN'),
        _f('num_expert', 'int', 0),
        _f('task_towers', 'msg:BayesTaskTower', rep=True),
        _f('l2_regularization', 'float', 1e-4),
    ),
    'SimpleMultiTask': (
        _f('task_towers', 'msg:TaskTower', rep=True),
        _f('l2_regularization', 'float', 1e-4),
    ),
    'ExtractionNetwork': (
        _f('network_name', 'string', ''),
        _f('expert_num_per_task', 'int', 0),
        _f('share_num', 'int', 0),
        _f('task_expert_net', 'msg:DNN'),
        _f('share_expert_net', 'msg:DNN'),
    ),
    'PLE': (
        _f('extraction_networks', 'msg:ExtractionNetwork', rep=True),
        _f('task_towers', 'msg:TaskTower', rep=True),
        _f('l2_regularization', 'float', 1e-4),
    ),
    # a tower's metrics_set: per-task AUC is computed for every tower
    # whatever it lists; a metric of it that is not ported is refused.
    # task_space_indicator_name and _value only carry a column along in
    # the JAX package's batches, and its loss reads neither
    'TaskTower': (
        _f('tower_name', 'string', ''),
        _f('label_name', 'string', ''),
        _f('metrics_set', 'msg:EvalMetrics', rep=True),
        _f('loss_type', 'enum:LossType', 'CLASSIFICATION'),
        _f('num_class', 'int', 1),
        _f('dnn', 'msg:DNN'),
        _f('weight', 'float', 1.0),
        _f('task_space_indicator_label', 'string', ''),
        _f('in_task_space_weight', 'float', 1.0),
        _f('out_task_space_weight', 'float', 1.0),
        _f('losses', 'msg:Loss', rep=True),
        _f('use_sample_weight', 'bool', True),
    ),
    'BayesTaskTower': (
        _f('tower_name', 'string', ''),
        _f('label_name', 'string', ''),
        _f('metrics_set', 'msg:EvalMetrics', rep=True),
        _f('loss_type', 'enum:LossType', 'CLASSIFICATION'),
        _f('num_class', 'int', 1),
        _f('dnn', 'msg:DNN'),
        _f('relation_tower_names', 'string', rep=True),
        _f('relation_dnn', 'msg:DNN'),
        _f('weight', 'float', 1.0),
        _f('task_space_indicator_label', 'string', ''),
        _f('in_task_space_weight', 'float', 1.0),
        _f('out_task_space_weight', 'float', 1.0),
        _f('losses', 'msg:Loss', rep=True),
        _f('use_sample_weight', 'bool', True),
    ),
    # a loss list, of a task tower or of a rank model (`losses`);
    # loss_name and learn_loss_weight are read only by a rank model's
    'Loss': (
        _f('loss_type', 'enum:LossType', 'CLASSIFICATION'),
        _f('weight', 'float', 1.0),
        _f('loss_name', 'string', ''),
        _f('learn_loss_weight', 'bool', False),
        _f('f1_reweighted_loss', 'msg:F1ReweighedLoss', oneof='loss_param'),
        _f('binary_focal_loss', 'msg:BinaryFocalLoss', oneof='loss_param'),
        _f('softmax_loss', 'msg:SoftmaxCrossEntropyWithNegativeMining',
           oneof='loss_param'),
        _f('circle_loss', 'msg:CircleLoss', oneof='loss_param'),
        _f('multi_simi_loss', 'msg:MultiSimilarityLoss', oneof='loss_param'),
        *_unported('loss_param', 'pairwise_loss', 'pairwise_focal_loss',
                   'pairwise_logistic_loss', 'jrc_loss',
                   'pairwise_hinge_loss', 'listwise_rank_loss',
                   'listwise_distill_loss', 'ziln_loss'),
    ),
    # knowledge distillation (BaseModel.kd_losses); its loss_param is read
    # by no term the port (or the JAX package) computes but
    # LISTWISE_DISTILL_LOSS's, which check_ported refuses
    'KD': (
        _f('loss_name', 'string', ''),
        _f('pred_name', 'string', ''),
        _f('pred_is_logits', 'bool', True),
        _f('soft_label_name', 'string', ''),
        _f('label_is_logits', 'bool', True),
        _f('loss_type', 'enum:LossType', 'CLASSIFICATION'),
        _f('loss_weight', 'float', 1.0),
        _f('temperature', 'float', 1.0),
        _f('task_space_indicator_name', 'string', ''),
        _f('task_space_indicator_value', 'string', ''),
        _f('in_task_space_weight', 'float', 1.0),
        _f('out_task_space_weight', 'float', 1.0),
        _f('f1_reweighted_loss', 'msg:F1ReweighedLoss', oneof='loss_param'),
        _f('softmax_loss', 'msg:SoftmaxCrossEntropyWithNegativeMining',
           oneof='loss_param'),
        _f('circle_loss', 'msg:CircleLoss', oneof='loss_param'),
        _f('multi_simi_loss', 'msg:MultiSimilarityLoss', oneof='loss_param'),
        _f('binary_focal_loss', 'msg:BinaryFocalLoss', oneof='loss_param'),
        *_unported('loss_param', 'pairwise_loss', 'pairwise_focal_loss',
                   'pairwise_logistic_loss', 'jrc_loss',
                   'pairwise_hinge_loss', 'listwise_rank_loss',
                   'listwise_distill_loss'),
    ),
    'SoftmaxCrossEntropyWithNegativeMining': (
        _f('num_negative_samples', 'int', 0),
        _f('margin', 'float', 0.0),
        _f('gamma', 'float', 1.0),
        _f('coefficient_of_support_vector', 'float', 1.0),
    ),
    'CircleLoss': (
        _f('margin', 'float', 0.25),
        _f('gamma', 'float', 32.0),
    ),
    'MultiSimilarityLoss': (
        _f('alpha', 'float', 2.0),
        _f('beta', 'float', 50.0),
        _f('lamb', 'float', 1.0),
        _f('eps', 'float', 0.1),
    ),
    # the match family (models/match.py, models/match_extra.py)
    'DSSMTower': (
        _f('id', 'string', ''),
        _f('dnn', 'msg:DNN'),
    ),
    'DSSM': (
        _f('user_tower', 'msg:DSSMTower'),
        _f('item_tower', 'msg:DSSMTower'),
        _f('l2_regularization', 'float', 1e-4),
        _f('simi_func', 'enum:Similarity', 'COSINE'),
        _f('scale_simi', 'bool', True),
        _f('item_id', 'string', ''),
        _f('ignore_in_batch_neg_sam', 'bool', False),
        _f('temperature', 'float', 1.0),
    ),
    'DSSM_SENet_Tower': (
        _f('id', 'string', ''),
        _f('senet', 'msg:SENet'),
        _f('dnn', 'msg:DNN'),
    ),
    'DSSM_SENet': (
        _f('user_tower', 'msg:DSSM_SENet_Tower'),
        _f('item_tower', 'msg:DSSM_SENet_Tower'),
        _f('l2_regularization', 'float', 1e-4),
        _f('simi_func', 'enum:Similarity', 'COSINE'),
        _f('scale_simi', 'bool', True),
        _f('item_id', 'string', ''),
        _f('ignore_in_batch_neg_sam', 'bool', False),
        _f('temperature', 'float', 1.0),
    ),
    'DATTower': (
        _f('id', 'string', ''),
        _f('dnn', 'msg:DNN'),
    ),
    'DAT': (
        _f('user_tower', 'msg:DATTower'),
        _f('item_tower', 'msg:DATTower'),
        _f('l2_regularization', 'float', 1e-4),
        _f('simi_func', 'enum:Similarity', 'COSINE'),
        _f('ignore_in_batch_neg_sam', 'bool', False),
        _f('temperature', 'float', 1.0),
        _f('amm_i_weight', 'float', 0.5),
        _f('amm_u_weight', 'float', 0.5),
    ),
    # max_seq_len and scale_ratio are read by neither package's capsule
    'Capsule': (
        _f('max_k', 'int', 5),
        _f('max_seq_len', 'int', 0),
        _f('high_dim', 'int', 0),
        _f('num_iters', 'int', 3),
        _f('routing_logits_scale', 'float', 20.0),
        _f('routing_logits_stddev', 'float', 1.0),
        _f('squash_pow', 'float', 1.0),
        _f('scale_ratio', 'float', 1.0),
        _f('const_caps_num', 'bool', False),
    ),
    'MIND': (
        _f('pre_capsule_dnn', 'msg:DNN'),
        _f('user_dnn', 'msg:DNN'),
        _f('concat_dnn', 'msg:DNN'),
        _f('user_seq_combine', 'enum:UserSeqCombineMethod', 'SUM'),
        _f('item_dnn', 'msg:DNN'),
        _f('capsule_config', 'msg:Capsule'),
        _f('simi_pow', 'float', 10.0),
        _f('simi_func', 'enum:Similarity', 'COSINE'),
        _f('scale_simi', 'bool', True),
        _f('l2_regularization', 'float', 1e-4),
        _f('time_id_fea', 'string', ''),
        _f('item_id', 'string', ''),
        _f('ignore_in_batch_neg_sam', 'bool', False),
        _f('max_interests_simi', 'float', 1.0),
    ),
    'DropoutNet': (
        _f('user_content', 'msg:DNN'),
        _f('user_preference', 'msg:DNN'),
        _f('item_content', 'msg:DNN'),
        _f('item_preference', 'msg:DNN'),
        _f('user_tower', 'msg:DNN'),
        _f('item_tower', 'msg:DNN'),
        _f('l2_regularization', 'float', 0.0),
        _f('user_dropout_rate', 'float', 0.0),
        _f('item_dropout_rate', 'float', 0.5),
        _f('softmax_loss', 'msg:SoftmaxCrossEntropyWithNegativeMining'),
    ),
    'CoMetricLearningI2I': (
        _f('session_id', 'string', ''),
        _f('highway', 'msg:HighWayTower', rep=True),
        _f('input', 'string', ''),
        _f('dnn', 'msg:DNN'),
        _f('l2_regularization', 'float', 1e-4),
        _f('output_l2_normalized_emb', 'bool', True),
        _f('sample_id', 'string', ''),
        _f('circle_loss', 'msg:CircleLoss', oneof='loss'),
        _f('multi_similarity_loss', 'msg:MultiSimilarityLoss', oneof='loss'),
        _f('item_id', 'string', ''),
    ),
    'PDN': (
        _f('user_dnn', 'msg:DNN'),
        _f('item_dnn', 'msg:DNN'),
        _f('u2i_dnn', 'msg:DNN'),
        _f('trigger_dnn', 'msg:DNN'),
        _f('i2i_dnn', 'msg:DNN'),
        _f('sim_dnn', 'msg:DNN'),
        _f('direct_user_dnn', 'msg:DNN'),
        _f('direct_item_dnn', 'msg:DNN'),
        _f('simi_func', 'enum:Similarity', 'COSINE'),
        _f('scale_simi', 'bool', True),
        _f('bias_dnn', 'msg:DNN'),
        _f('item_id', 'string', ''),
        _f('l2_regularization', 'float', 1e-6),
    ),
    'RecallTower': (
        _f('dnn', 'msg:DNN'),
    ),
    'MultiTowerRecall': (
        _f('user_tower', 'msg:RecallTower'),
        _f('item_tower', 'msg:RecallTower'),
        _f('l2_regularization', 'float', 1e-4),
        _f('final_dnn', 'msg:DNN'),
        _f('ignore_in_batch_neg_sam', 'bool', False),
    ),
    'F1ReweighedLoss': (
        _f('f1_beta_square', 'float', 1.0),
        _f('label_smoothing', 'float', 0.0),
    ),
    'BinaryFocalLoss': (
        _f('gamma', 'float', 2.0),
        _f('alpha', 'float', 0.0),
        _f('ohem_ratio', 'float', 1.0),
        _f('label_smoothing', 'float', 0.0),
    ),
    # models.proto: the backbone models' parameters and variational dropout
    'ModelParams': (
        _f('l2_regularization', 'float', 0.0),
        _f('outputs', 'string', rep=True),
        _f('task_towers', 'msg:BayesTaskTower', rep=True),
        _f('user_tower_idx_in_output', 'int', 0),
        _f('item_tower_idx_in_output', 'int', 1),
        _f('simi_func', 'enum:Similarity', 'COSINE'),
        _f('temperature', 'float', 1.0),
        _f('scale_simi', 'bool', False),
    ),
    'VariationalDropoutLayer': (
        _f('regularization_lambda', 'float', 0.01),
        _f('embedding_wise_variational_dropout', 'bool', False),
    ),
    # layers.proto:238-380, the backbone DSL
    'BackboneTower': (
        _f('packages', 'msg:BlockPackage', rep=True),
        _f('blocks', 'msg:Block', rep=True),
        _f('concat_blocks', 'string', rep=True),
        _f('output_blocks', 'string', rep=True),
        _f('top_mlp', 'msg:MLP'),
    ),
    'BlockPackage': (
        _f('name', 'string', ''),
        _f('blocks', 'msg:Block', rep=True),
        _f('concat_blocks', 'string', rep=True),
        _f('output_blocks', 'string', rep=True),
    ),
    'Block': (
        _f('name', 'string', ''),
        _f('inputs', 'msg:BlockInput', rep=True),
        _f('input_concat_axis', 'int', -1),
        _f('merge_inputs_into_list', 'bool', False),
        _f('extra_input_fn', 'string', ''),
        _f('layers', 'msg:Layer', rep=True),
        _f('input_layer', 'msg:InputLayer', oneof='layer'),
        _f('lambda', 'msg:Lambda', oneof='layer'),
        _f('keras_layer', 'msg:KerasLayer', oneof='layer'),
        _f('recurrent', 'msg:RecurrentLayer', oneof='layer'),
        _f('repeat', 'msg:RepeatLayer', oneof='layer'),
        _f('raw_input', 'msg:RawInputLayer', oneof='layer'),
        _f('embedding_layer', 'msg:EmbeddingLayer', oneof='layer'),
    ),
    # reset_input is read by neither package's backbone
    'BlockInput': (
        _f('feature_group_name', 'string', '', oneof='name'),
        _f('block_name', 'string', '', oneof='name'),
        _f('package_name', 'string', '', oneof='name'),
        _f('use_package_input', 'bool', False, oneof='name'),
        _f('input_fn', 'string', ''),
        _f('input_slice', 'string', ''),
        _f('ignore_input', 'bool', False),
        _f('reset_input', 'msg:InputLayer'),
        _f('package_input', 'string', ''),
        _f('package_input_fn', 'string', ''),
    ),
    'Layer': (
        _f('lambda', 'msg:Lambda', oneof='layer'),
        _f('keras_layer', 'msg:KerasLayer', oneof='layer'),
        _f('recurrent', 'msg:RecurrentLayer', oneof='layer'),
        _f('repeat', 'msg:RepeatLayer', oneof='layer'),
    ),
    'Lambda': (
        _f('expression', 'string', ''),
    ),
    'RecurrentLayer': (
        _f('num_steps', 'int', 1),
        _f('fixed_input_index', 'int', 0),
        _f('keras_layer', 'msg:KerasLayer'),
    ),
    'RepeatLayer': (
        _f('num_repeat', 'int', 1),
        _f('output_concat_axis', 'int', 0),
        _f('keras_layer', 'msg:KerasLayer'),
        _f('input_slice', 'string', ''),
        _f('input_fn', 'string', ''),
    ),
    # wide_output_dim and concat_seq_feature are read by neither package's
    # backbone
    'InputLayer': (
        _f('do_batch_norm', 'bool', False),
        _f('do_layer_norm', 'bool', False),
        _f('dropout_rate', 'float', 0.0),
        _f('feature_dropout_rate', 'float', 0.0),
        _f('only_output_feature_list', 'bool', False),
        _f('only_output_3d_tensor', 'bool', False),
        _f('output_2d_tensor_and_feature_list', 'bool', False),
        _f('output_seq_and_normal_feature', 'bool', False),
        _f('wide_output_dim', 'int', 0),
        _f('concat_seq_feature', 'bool', True),
    ),
    'RawInputLayer': (),
    'EmbeddingLayer': (
        _f('embedding_dim', 'int', 0),
        _f('vocab_size', 'int', 0),
        _f('combiner', 'string', 'weight'),
        _f('concat', 'bool', True),
    ),
    # OverlapFeature and MappedDotProduct have no layer in either
    # package's registry
    'KerasLayer': (
        _f('class_name', 'string', ''),
        _f('st_params', 'msg:Struct', oneof='params'),
        _f('periodic_embedding', 'msg:PeriodicEmbedding', oneof='params'),
        _f('auto_dis_embedding', 'msg:AutoDisEmbedding', oneof='params'),
        _f('nary_dis_embedding', 'msg:NaryDisEmbedding', oneof='params'),
        _f('fm', 'msg:FM', oneof='params'),
        _f('mask_block', 'msg:MaskBlock', oneof='params'),
        _f('masknet', 'msg:MaskNet', oneof='params'),
        _f('senet', 'msg:SENet', oneof='params'),
        _f('bilinear', 'msg:Bilinear', oneof='params'),
        _f('fibinet', 'msg:FiBiNet', oneof='params'),
        _f('mlp', 'msg:MLP', oneof='params'),
        _f('din', 'msg:DINEncoder', oneof='params'),
        _f('bst', 'msg:BSTEncoder', oneof='params'),
        _f('mmoe', 'msg:MMoELayer', oneof='params'),
        _f('seq_aug', 'msg:SequenceAugment', oneof='params'),
        _f('ppnet', 'msg:PPNet', oneof='params'),
        _f('text_cnn', 'msg:TextCNN', oneof='params'),
        _f('highway', 'msg:HighWayTower', oneof='params'),
        *_unported('params', 'overlap', 'dot_product'),
        _f('attention', 'msg:Attention', oneof='params'),
        _f('multi_head_attention', 'msg:MultiHeadAttention',
           oneof='params'),
        _f('transformer', 'msg:Transformer', oneof='params'),
        _f('text_encoder', 'msg:TextEncoder', oneof='params'),
        _f('gate', 'msg:WeightedGate', oneof='params'),
        _f('aitm', 'msg:AITMTower', oneof='params'),
        _f('cin', 'msg:CIN', oneof='params'),
    ),
    # google/protobuf/struct.proto, the free-form st_params: its map
    # `fields` is a list of key/value entries
    'Struct': (
        _f('fields', 'msg:StructFieldsEntry', rep=True),
    ),
    'StructFieldsEntry': (
        _f('key', 'string', ''),
        _f('value', 'msg:Value'),
    ),
    'Value': (
        _f('null_value', 'enum:NullValue', 'NULL_VALUE', oneof='kind'),
        _f('number_value', 'double', 0.0, oneof='kind'),
        _f('string_value', 'string', '', oneof='kind'),
        _f('bool_value', 'bool', False, oneof='kind'),
        _f('struct_value', 'msg:Struct', oneof='kind'),
        _f('list_value', 'msg:ListValue', oneof='kind'),
    ),
    'ListValue': (
        _f('values', 'msg:Value', rep=True),
    ),
    # layers.proto:16-236, the layers' parameters
    'HighWayTower': (
        _f('input', 'string', ''),
        _f('emb_size', 'int', 0),
        _f('activation', 'string', 'relu'),
        _f('dropout_rate', 'float', 0.0),
        _f('init_gate_bias', 'float', -3.0),
        _f('num_layers', 'int', 1),
    ),
    'PeriodicEmbedding': (
        _f('embedding_dim', 'int', 0),
        _f('sigma', 'float', 0.0),
        _f('add_linear_layer', 'bool', True),
        _f('linear_activation', 'string', 'relu'),
        _f('output_3d_tensor', 'bool', False),
        _f('output_tensor_list', 'bool', False),
    ),
    'AutoDisEmbedding': (
        _f('embedding_dim', 'int', 0),
        _f('num_bins', 'int', 0),
        _f('keep_prob', 'float', 0.8),
        _f('temperature', 'float', 0.0),
        _f('output_3d_tensor', 'bool', False),
        _f('output_tensor_list', 'bool', False),
    ),
    # num_replicas is read by neither package's NaryDisEmbedding
    'NaryDisEmbedding': (
        _f('embedding_dim', 'int', 0),
        _f('carries', 'int', rep=True),
        _f('multiplier', 'float', 1.0),
        _f('intra_ary_pooling', 'string', 'sum'),
        _f('inter_ary_pooling', 'string', 'concat'),
        _f('output_3d_tensor', 'bool', False),
        _f('output_tensor_list', 'bool', False),
        _f('num_replicas', 'int', 1),
    ),
    'SENet': (
        _f('reduction_ratio', 'int', 4),
        _f('num_squeeze_group', 'int', 2),
        _f('use_skip_connection', 'bool', True),
        _f('use_output_layer_norm', 'bool', True),
    ),
    'Bilinear': (
        _f('type', 'string', 'interaction'),
        _f('use_plus', 'bool', True),
        _f('num_output_units', 'int', 0),
    ),
    'FiBiNet': (
        _f('bilinear', 'msg:Bilinear'),
        _f('senet', 'msg:SENet'),
        _f('mlp', 'msg:MLP'),
    ),
    'MaskBlock': (
        _f('reduction_factor', 'float', 0.0),
        _f('output_size', 'int', 0),
        _f('aggregation_size', 'int', 0),
        _f('input_layer_norm', 'bool', False),
        _f('projection_dim', 'int', 0),
    ),
    'MaskNet': (
        _f('mask_blocks', 'msg:MaskBlock', rep=True),
        _f('use_parallel', 'bool', True),
        _f('mlp', 'msg:MLP'),
        _f('input_layer_norm', 'bool', True),
    ),
    'MMoELayer': (
        _f('num_task', 'int', 0),
        _f('expert_mlp', 'msg:MLP'),
        _f('num_expert', 'int', 0),
    ),
    'WeightedGate': (
        _f('weight_index', 'int', 0),
        _f('mlp', 'msg:MLP'),
    ),
    'GateNN': (
        _f('output_dim', 'int', 0),
        _f('hidden_dim', 'int', 0),
        _f('activation', 'string', 'relu'),
        _f('use_bn', 'bool', False),
        _f('dropout_rate', 'float', 0.0),
    ),
    'PPNet': (
        _f('mlp', 'msg:MLP'),
        _f('gate_params', 'msg:GateNN'),
        _f('mode', 'string', 'eager'),
        _f('full_gate_input', 'bool', True),
    ),
    'TextCNN': (
        _f('filter_sizes', 'int', rep=True),
        _f('num_filters', 'int', rep=True),
        _f('pad_sequence_length', 'int', 0),
        _f('activation', 'string', 'relu'),
        _f('mlp', 'msg:MLP'),
    ),
    'AITMTower': (
        _f('project_dim', 'int', 0),
        _f('transfer_mlp', 'msg:MLP'),
        _f('stop_gradient', 'bool', True),
    ),
    'CIN': (
        _f('hidden_feature_sizes', 'int', rep=True),
    ),
    # layers.proto's FM (the model's message is FMModel)
    'FM': (
        _f('use_variant', 'bool', False),
        _f('l2_regularization', 'float', 1e-4),
    ),
    'Attention': (
        _f('use_scale', 'bool', False),
        _f('scale_by_dim', 'bool', False),
        _f('score_mode', 'string', 'dot'),
        _f('dropout', 'float', 0.0),
        _f('seed', 'int', 0),
        _f('return_attention_scores', 'bool', False),
        _f('use_causal_mask', 'bool', False),
    ),
    'MultiHeadAttention': (
        _f('num_heads', 'int', 0),
        _f('key_dim', 'int', 0),
        _f('value_dim', 'int', 0),
        _f('dropout', 'float', 0.0),
        _f('use_bias', 'bool', True),
        _f('return_attention_scores', 'bool', False),
        _f('use_causal_mask', 'bool', False),
        _f('output_shape', 'int', 0),
        _f('attention_axes', 'int', rep=True),
        _f('kernel_initializer', 'string', 'glorot_uniform'),
        _f('bias_initializer', 'string', 'zeros'),
    ),
    'Transformer': (
        _f('hidden_size', 'int', 0),
        _f('num_hidden_layers', 'int', 0),
        _f('num_attention_heads', 'int', 0),
        _f('intermediate_size', 'int', 0),
        _f('hidden_act', 'string', 'relu'),
        _f('hidden_dropout_prob', 'float', 0.1),
        _f('vocab_size', 'int', 0),
        _f('max_position_embeddings', 'int', 512),
        _f('use_position_embeddings', 'bool', False),
        _f('output_all_token_embeddings', 'bool', True),
        _f('attention_probs_dropout_prob', 'float', 0.0),
    ),
    'TextEncoder': (
        _f('transformer', 'msg:Transformer'),
        _f('separator', 'string', ' '),
        _f('vocab_file', 'string', ''),
        _f('default_token_id', 'int', 0),
    ),
    'BSTEncoder': (
        _f('hidden_size', 'int', 0),
        _f('num_hidden_layers', 'int', 0),
        _f('num_attention_heads', 'int', 0),
        _f('intermediate_size', 'int', 0),
        _f('hidden_act', 'string', 'gelu'),
        _f('hidden_dropout_prob', 'float', 0.1),
        _f('attention_probs_dropout_prob', 'float', 0.1),
        _f('max_position_embeddings', 'int', 512),
        _f('use_position_embeddings', 'bool', True),
        _f('initializer_range', 'float', 0.02),
        _f('output_all_token_embeddings', 'bool', True),
        _f('target_item_position', 'string', 'head'),
        _f('reserve_target_position', 'bool', True),
        _f('pre_ln', 'bool', False),
    ),
    'DINEncoder': (
        _f('attention_dnn', 'msg:MLP'),
        _f('need_target_feature', 'bool', True),
        _f('attention_normalizer', 'string', 'softmax'),
    ),
    'SequenceAugment': (
        _f('mask_rate', 'float', 0.6),
        _f('crop_rate', 'float', 0.2),
        _f('reorder_rate', 'float', 0.6),
    ),
    # common.proto
    'Tower': (
        _f('input', 'string', ''),
        _f('dnn', 'msg:DNN'),
    ),
    # add_to_outputs is read by neither package's MLP
    'MLP': (
        _f('hidden_units', 'int', rep=True),
        _f('dropout_ratio', 'float', rep=True),
        _f('activation', 'string', 'relu'),
        _f('use_bn', 'bool', True),
        _f('use_final_bn', 'bool', True),
        _f('final_activation', 'string', 'relu'),
        _f('use_bias', 'bool', False),
        _f('initializer', 'string', 'he_uniform'),
        _f('use_bn_after_activation', 'bool', False),
        _f('use_final_bias', 'bool', False),
        _f('add_to_outputs', 'bool', False),
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
        _f('negative_sampler', 'msg:NegativeSampler', oneof='sampler'),
        _f('negative_sampler_v2', 'msg:NegativeSamplerV2', oneof='sampler'),
        _f('hard_negative_sampler', 'msg:HardNegativeSampler',
           oneof='sampler'),
        _f('hard_negative_sampler_v2', 'msg:HardNegativeSamplerV2',
           oneof='sampler'),
        _f('negative_sampler_in_memory', 'msg:NegativeSamplerInMemory',
           oneof='sampler'),
        _f('eval_batch_size', 'int', 4096),
        _f('drop_remainder', 'bool', False),
        _f('max_tag_len', 'int', 16),
        _f('file_shard', 'bool', False),
        _f('data_compression_type', 'string', ''),
    ),
    # the negative samplers (data/samplers.py); field_delimiter is read by
    # neither package's loader (GraphLearn's tab-separated text)
    'NegativeSampler': (
        _f('input_path', 'string', ''),
        _f('num_sample', 'int', 0),
        _f('attr_fields', 'string', rep=True),
        _f('item_id_field', 'string', ''),
        _f('attr_delimiter', 'string', ':'),
        _f('num_eval_sample', 'int', 0),
        _f('field_delimiter', 'string', '\001'),
    ),
    'NegativeSamplerInMemory': (
        _f('input_path', 'string', ''),
        _f('num_sample', 'int', 0),
        _f('attr_fields', 'string', rep=True),
        _f('item_id_field', 'string', ''),
        _f('attr_delimiter', 'string', ':'),
        _f('num_eval_sample', 'int', 0),
        _f('field_delimiter', 'string', '\001'),
    ),
    'NegativeSamplerV2': (
        _f('user_input_path', 'string', ''),
        _f('item_input_path', 'string', ''),
        _f('pos_edge_input_path', 'string', ''),
        _f('num_sample', 'int', 0),
        _f('attr_fields', 'string', rep=True),
        _f('item_id_field', 'string', ''),
        _f('user_id_field', 'string', ''),
        _f('attr_delimiter', 'string', ':'),
        _f('num_eval_sample', 'int', 0),
        _f('field_delimiter', 'string', '\001'),
    ),
    'HardNegativeSampler': (
        _f('user_input_path', 'string', ''),
        _f('item_input_path', 'string', ''),
        _f('hard_neg_edge_input_path', 'string', ''),
        _f('num_sample', 'int', 0),
        _f('num_hard_sample', 'int', 0),
        _f('attr_fields', 'string', rep=True),
        _f('item_id_field', 'string', ''),
        _f('user_id_field', 'string', ''),
        _f('attr_delimiter', 'string', ':'),
        _f('num_eval_sample', 'int', 0),
        _f('field_delimiter', 'string', '\001'),
    ),
    'HardNegativeSamplerV2': (
        _f('user_input_path', 'string', ''),
        _f('item_input_path', 'string', ''),
        _f('pos_edge_input_path', 'string', ''),
        _f('hard_neg_edge_input_path', 'string', ''),
        _f('num_sample', 'int', 0),
        _f('num_hard_sample', 'int', 0),
        _f('attr_fields', 'string', rep=True),
        _f('item_id_field', 'string', ''),
        _f('user_id_field', 'string', ''),
        _f('attr_delimiter', 'string', ':'),
        _f('num_eval_sample', 'int', 0),
        _f('field_delimiter', 'string', '\001'),
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
        _f('kv_separator', 'string', ''),
        _f('seq_multi_sep', 'string', ''),
        _f('expression', 'unported'),
        _f('combo_input_seps', 'unported', rep=True),
        _f('sequence_combiner', 'msg:SequenceCombiner'),
    ),
    'SequenceCombiner': (
        _f('attention', 'msg:AttentionCombiner', oneof='combiner'),
        _f('multi_head_attention', 'msg:MultiHeadAttentionCombiner',
           oneof='combiner'),
        _f('text_cnn', 'msg:TextCnnCombiner', oneof='combiner'),
    ),
    'AttentionCombiner': (),
    'MultiHeadAttentionCombiner': (),
    'TextCnnCombiner': (
        _f('filter_sizes', 'int', rep=True),
        _f('num_filters', 'int', rep=True),
        # the JAX package's _combine_sequence reads neither
        _f('pad_sequence_length', 'unported'),
        _f('mlp', 'unported'),
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
        _f('sequence_features', 'msg:SeqAttGroupConfig', rep=True),
    ),
    'SeqAttGroupConfig': (
        _f('group_name', 'string', ''),
        _f('seq_att_map', 'msg:SeqAttMap', rep=True),
        _f('seq_dnn', 'msg:DNN'),
        _f('need_key_feature', 'bool', True),
        _f('allow_key_transform', 'bool', False),
        _f('transform_dnn', 'bool', False),
    ),
    'SeqAttMap': (
        _f('key', 'string', rep=True),
        _f('hist_seq', 'string', rep=True),
        _f('aux_hist_seq', 'string', rep=True),
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
