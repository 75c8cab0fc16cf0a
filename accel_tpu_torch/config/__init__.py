from accel_tpu_torch.config.loader import (  # noqa: F401
    Config,
    default_config,
    load_config,
    safe_load,
    update_config,
)
