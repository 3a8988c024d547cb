from .configs import CONFIGS, PipelineConfig, get_config  # noqa: F401
