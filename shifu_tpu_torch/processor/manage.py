"""`shifu save/switch/show` — model-set versioning.

Parity: core/processor/ManageModelProcessor.java:30 — git-branch-like local
bookkeeping of (ModelConfig.json, ColumnConfig.json, models/) snapshots under
.shifu/backup/<version>.

The port's own copy of `shifu_tpu/processor/manage.py`. It touches no
device.
"""

from __future__ import annotations

import datetime
import os
import shutil

from shifu_tpu_torch.processor.basic import BasicProcessor
from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)


class ManageProcessor(BasicProcessor):
    step = "manage"
    host_only = True

    def __init__(self, command: str, version: str = None, root: str = "."):
        super().__init__(root)
        self.command = command
        self.version = version

    def run_step(self) -> None:
        if self.command == "show":
            self._show()
            return
        self.setup(need_columns=False)
        if self.command == "save":
            self._save()
        elif self.command == "switch":
            self._switch()

    def _versions_root(self) -> str:
        return os.path.join(self.root, ".shifu", "backup")

    def _save(self) -> None:
        version = self.version or datetime.datetime.now().strftime(
            "%Y%m%d-%H%M%S"
        )
        dst = self.paths.backup_dir(version)
        if os.path.isdir(dst):
            raise ShifuError(ErrorCode.INVALID_MODEL_CONFIG,
                             f"version {version} already exists")
        os.makedirs(dst, exist_ok=True)
        for name in ("ModelConfig.json", "ColumnConfig.json"):
            src = os.path.join(self.root, name)
            if os.path.isfile(src):
                shutil.copy(src, os.path.join(dst, name))
        models = self.paths.models_dir()
        if os.path.isdir(models):
            shutil.copytree(models, os.path.join(dst, "models"))
        log.info("model set saved as version %s", version)

    def _switch(self) -> None:
        src = self.paths.backup_dir(self.version)
        if not os.path.isdir(src):
            raise ShifuError(ErrorCode.INVALID_MODEL_CONFIG,
                             f"version {self.version} not found")
        for name in ("ModelConfig.json", "ColumnConfig.json"):
            p = os.path.join(src, name)
            if os.path.isfile(p):
                shutil.copy(p, os.path.join(self.root, name))
        models_bak = os.path.join(src, "models")
        if os.path.isdir(models_bak):
            shutil.rmtree(self.paths.models_dir(), ignore_errors=True)
            shutil.copytree(models_bak, self.paths.models_dir())
        log.info("switched to version %s", self.version)

    def _show(self) -> None:
        root = self._versions_root()
        if not os.path.isdir(root):
            log.info("no saved versions.")
            return
        for v in sorted(os.listdir(root)):
            log.info("version: %s", v)
