from .schema import (  # noqa: F401
    ConfigError,
    TrainEvalPipelineConfig,
    load_pipeline_config,
    loads_pipeline_config,
)
