"""`shifu train` (counterpart of `shifu_tpu/processor/train.py`).

Parity: core/processor/TrainModelProcessor.java:105 — per-algorithm
dispatch, model-file suffixes, progress and val-error files. The port
trains the tree family (GBT, RF, DT) on one device; NN/LR/SVM and WDL
raise NotImplementedError until their slices land.
"""

from __future__ import annotations

from shifu_tpu_torch.config.model_config import Algorithm
from shifu_tpu_torch.processor.basic import BasicProcessor
from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike

log = get_logger(__name__)


class TrainProcessor(BasicProcessor):
    step = "train"

    def __init__(self, root: str = ".", dry: bool = False,
                 device: DeviceLike = None):
        super().__init__(root, device=device)
        self.dry = dry

    # ---- helpers ----
    def _model_suffix(self, alg: Algorithm) -> str:
        return {
            Algorithm.NN: "nn",
            Algorithm.LR: "lr",
            Algorithm.GBT: "gbt",
            Algorithm.RF: "rf",
            Algorithm.DT: "rf",
            Algorithm.WDL: "wdl",
        }.get(alg, "nn")

    def run_step(self) -> None:
        self.setup()
        mc = self.model_config
        assert mc is not None
        alg = mc.train.algorithm

        if self.dry:
            log.info("dry run: config validated, algorithm=%s", alg.value)
            return

        if alg in (Algorithm.NN, Algorithm.LR, Algorithm.SVM):
            raise NotImplementedError(
                f"{alg.value} training is not ported yet: ROADMAP A.8")
        elif alg in (Algorithm.GBT, Algorithm.RF, Algorithm.DT):
            self._train_tree_family(alg)
        elif alg == Algorithm.WDL:
            raise NotImplementedError(
                "WDL training is not ported yet: ROADMAP A.12")
        else:
            raise ShifuError(
                ErrorCode.INVALID_MODEL_CONFIG, f"algorithm {alg.value} not supported"
            )

    def _train_tree_family(self, alg: Algorithm) -> None:
        from shifu_tpu_torch.processor.train_tree import train_tree_models

        train_tree_models(self, alg)
