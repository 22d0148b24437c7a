"""Configuration objects: ModelConfig / ColumnConfig and their validation.

The port's own copy of `shifu_tpu/config/__init__.py`, the same code and the same bytes on
disk; the port imports nothing of the JAX package.

JSON wire format is compatible with the reference's Jackson POJOs
(container/obj/ModelConfig.java:57, container/obj/ColumnConfig.java:35) so that
model sets created by the reference load verbatim.
"""

from shifu_tpu_torch.config.model_config import (  # noqa: F401
    Algorithm,
    BinningMethod,
    EvalConfig,
    ModelBasicConf,
    ModelConfig,
    ModelNormalizeConf,
    ModelSourceDataConf,
    ModelStatsConf,
    ModelTrainConf,
    ModelVarSelectConf,
    NormType,
    RunMode,
)
from shifu_tpu_torch.config.column_config import (  # noqa: F401
    ColumnBinning,
    ColumnConfig,
    ColumnFlag,
    ColumnStats,
    ColumnType,
    load_column_config_list,
    save_column_config_list,
)
