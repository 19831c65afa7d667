from easyrec_torch.config.config_util import (  # noqa: F401
    EasyRecConfig,
    check_ported,
    edit_config,
    expand_input_paths,
    get_configs_from_pipeline_file,
    get_configs_from_pipeline_str,
    get_feature_configs,
)
