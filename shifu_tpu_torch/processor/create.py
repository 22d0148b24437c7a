"""`shifu new <ModelSetName>` — scaffold a model-set directory.

Parity: core/processor/CreateModelProcessor.java:34 — creates the directory,
a default ModelConfig.json for the chosen algorithm, and the column-role files.

The port's own copy of `shifu_tpu/processor/create.py`: the same files,
byte for byte. It touches no device.
"""

from __future__ import annotations

import os

from shifu_tpu_torch.config.model_config import Algorithm, new_model_config
from shifu_tpu_torch.fs.pathfinder import PathFinder
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)


def run_new(name: str, algorithm: str = "NN", root: str = ".") -> int:
    try:
        alg = Algorithm.parse(algorithm, Algorithm.NN)
    except ValueError as e:
        log.error("%s", e)
        return 1
    target = os.path.join(os.path.abspath(root), name)
    if os.path.exists(os.path.join(target, PathFinder.MODEL_CONFIG)):
        log.error("Model set %s already exists.", name)
        return 1
    os.makedirs(target, exist_ok=True)
    mc = new_model_config(name, alg)
    paths = PathFinder(target)
    # column-role name files, one name per line (reference columns/*.names)
    cols_dir = os.path.join(target, "columns")
    os.makedirs(cols_dir, exist_ok=True)
    for fname in (
        "meta.column.names",
        "categorical.column.names",
        "forceselect.column.names",
        "forceremove.column.names",
    ):
        path = os.path.join(cols_dir, fname)
        if not os.path.exists(path):
            open(path, "w").close()
    mc.data_set.meta_column_name_file = "columns/meta.column.names"
    mc.data_set.categorical_column_name_file = "columns/categorical.column.names"
    mc.var_select.force_select_column_name_file = "columns/forceselect.column.names"
    mc.var_select.force_remove_column_name_file = "columns/forceremove.column.names"
    mc.save(paths.model_config_path())
    log.info("Model set %s created (algorithm=%s).", name, alg.value)
    log.info("Edit %s then run `shifu init`.", paths.model_config_path())
    return 0
