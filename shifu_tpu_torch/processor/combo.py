"""`shifu combo` — ensemble-of-algorithms workflow.

Parity: core/processor/ComboModelProcessor.java:45 + combo/* — NEW declares
the algorithm list (last = assembler), INIT scaffolds one sub-model-set dir
per member, RUN trains members then joins their training-data scores into
the assembler's training set (combo/PigDataJoin equivalent) and trains the
assembler, EVAL scores the eval set through members -> assembler.

Counterpart of `shifu_tpu/processor/combo.py` in the port: each member and
the assembler run the port's init -> stats -> norm -> train processors,
and the members' scores and the combo eval come from the port's
`ModelRunner`, all on the processor's device.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from shifu_tpu_torch.config.model_config import Algorithm, ModelConfig
from shifu_tpu_torch.processor.basic import BasicProcessor
from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike

log = get_logger(__name__)

COMBO_SPEC = "ComboTrain.json"


class ComboProcessor(BasicProcessor):
    step = "combo"

    def __init__(self, root: str = ".", new_algs: Optional[str] = None,
                 do_init: bool = False, do_run: bool = False,
                 do_eval: bool = False, device: DeviceLike = None):
        super().__init__(root, device=device)
        self.new_algs = new_algs
        self.do_init = do_init
        self.do_run = do_run
        self.do_eval = do_eval

    @classmethod
    def from_args(cls, args) -> "ComboProcessor":
        return cls(new_algs=args.new_algs, do_init=args.do_init,
                   do_run=args.do_run, do_eval=args.do_eval,
                   device=args.device)

    # ---- spec ----
    def _spec_path(self) -> str:
        return os.path.join(self.root, COMBO_SPEC)

    def _load_spec(self) -> dict:
        if not os.path.isfile(self._spec_path()):
            raise ShifuError(ErrorCode.INVALID_MODEL_CONFIG,
                             "no ComboTrain.json — run `shifu combo -new ...`")
        with open(self._spec_path()) as fh:
            return json.load(fh)

    def _member_dir(self, i: int, alg: str) -> str:
        return os.path.join(self.root, f"sub_{i}_{alg}")

    def _assembler_dir(self, alg: str) -> str:
        return os.path.join(self.root, f"assembler_{alg}")

    def run_step(self) -> None:
        if self.new_algs:
            algs = [a.strip().upper() for a in self.new_algs.split(",") if a.strip()]
            if len(algs) < 2:
                raise ShifuError(ErrorCode.INVALID_MODEL_CONFIG,
                                 "combo needs >= 2 algorithms (last = assembler)")
            with open(self._spec_path(), "w") as fh:
                json.dump({"members": algs[:-1], "assembler": algs[-1]}, fh,
                          indent=2)
            log.info("combo spec: members=%s assembler=%s", algs[:-1], algs[-1])
            return

        spec = self._load_spec()
        if self.do_init:
            self._init(spec)
        if self.do_run:
            self._run(spec)
        if self.do_eval:
            self._eval(spec)
        if not (self.do_init or self.do_run or self.do_eval):
            log.info("combo spec: %s", spec)

    # ---- steps ----
    def _init(self, spec: dict) -> None:
        self.setup(need_columns=False)
        from shifu_tpu_torch.config.model_config import default_train_params

        for i, alg in enumerate(spec["members"]):
            d = self._member_dir(i, alg)
            os.makedirs(d, exist_ok=True)
            mc = ModelConfig.load(self.paths.model_config_path())
            mc.basic.name = f"{mc.basic.name}_sub{i}_{alg}"
            mc.train.algorithm = Algorithm.parse(alg)
            mc.train.params = default_train_params(mc.train.algorithm)
            # data paths resolve relative to the member dir
            mc.data_set.data_path = os.path.relpath(
                self.resolve(mc.data_set.data_path), d)
            if mc.data_set.header_path:
                mc.data_set.header_path = os.path.relpath(
                    self.resolve(mc.data_set.header_path), d)
            mc.save(os.path.join(d, "ModelConfig.json"))
            log.info("member %d (%s) -> %s", i, alg, d)

    def _run_pipeline(self, d: str, steps=("init", "stats", "norm", "train")) -> None:
        from shifu_tpu_torch.processor.init import InitProcessor
        from shifu_tpu_torch.processor.norm import NormProcessor
        from shifu_tpu_torch.processor.stats import StatsProcessor
        from shifu_tpu_torch.processor.train import TrainProcessor

        mapping = {
            "init": InitProcessor, "stats": StatsProcessor,
            "norm": NormProcessor, "train": TrainProcessor,
        }
        for s in steps:
            assert mapping[s](d, device=self.device).run() == 0

    def _member_scores(self, spec: dict, data) -> np.ndarray:
        """[n, n_members] mean scores of each member on a raw dataset."""
        from shifu_tpu_torch.eval.scorer import ModelRunner, find_model_paths

        cols = []
        for i, alg in enumerate(spec["members"]):
            d = self._member_dir(i, alg)
            paths = find_model_paths(os.path.join(d, "models"))
            runner = ModelRunner(paths, device=self.device)
            cols.append(runner.score_raw(data).mean)
        return np.stack(cols, axis=1)

    def _load_raw(self):
        from shifu_tpu_torch.data.purify import combined_mask
        from shifu_tpu_torch.data.reader import make_tags, read_columnar, read_header

        mc = self.model_config
        ds = mc.data_set
        names = read_header(self.resolve(ds.header_path), ds.header_delimiter)
        data = read_columnar(self.resolve(ds.data_path), names,
                             delimiter=ds.data_delimiter,
                             missing_values=tuple(ds.missing_or_invalid_values))
        mask = combined_mask(ds.filter_expressions, data.raw, data.n_rows)
        data = data.select_rows(mask)
        tags = make_tags(data.column(ds.target_column_name), ds.pos_tags,
                         ds.neg_tags)
        return data, tags

    def _run(self, spec: dict) -> None:
        self.setup(need_columns=False)
        for i, alg in enumerate(spec["members"]):
            log.info("=== combo member %d: %s ===", i, alg)
            self._run_pipeline(self._member_dir(i, alg))

        # assembler training set: tag | member scores (combo/DataMerger)
        data, tags = self._load_raw()
        scores = self._member_scores(spec, data)
        alg = spec["assembler"]
        d = self._assembler_dir(alg)
        os.makedirs(os.path.join(d, "data"), exist_ok=True)
        names = [f"score_{i}" for i in range(scores.shape[1])]
        with open(os.path.join(d, "data", "header.txt"), "w") as fh:
            fh.write("|".join(["tag"] + names) + "\n")
        with open(os.path.join(d, "data", "data.txt"), "w") as fh:
            for i in range(scores.shape[0]):
                if tags[i] < 0:
                    continue
                fh.write("|".join([str(int(tags[i]))] +
                                  [f"{v:.4f}" for v in scores[i]]) + "\n")

        from shifu_tpu_torch.config.model_config import default_train_params, new_model_config

        amc = new_model_config(f"{self.model_config.basic.name}_assembler",
                               Algorithm.parse(alg))
        amc.data_set.data_path = "data/data.txt"
        amc.data_set.header_path = "data/header.txt"
        amc.data_set.target_column_name = "tag"
        amc.data_set.pos_tags = ["1"]
        amc.data_set.neg_tags = ["0"]
        amc.train.params = default_train_params(amc.train.algorithm)
        amc.save(os.path.join(d, "ModelConfig.json"))
        log.info("=== combo assembler: %s ===", alg)
        self._run_pipeline(d)
        log.info("combo run complete.")

    def _eval(self, spec: dict) -> None:
        self.setup(need_columns=False)
        from shifu_tpu_torch.data.reader import ColumnarData
        from shifu_tpu_torch.eval.metrics import evaluate_performance
        from shifu_tpu_torch.eval.scorer import ModelRunner, find_model_paths

        mc = self.model_config
        if not mc.evals:
            raise ShifuError(ErrorCode.INVALID_MODEL_CONFIG, "no eval sets")
        data, tags = self._load_raw()  # eval on training source by default
        scores = self._member_scores(spec, data)
        names = [f"score_{i}" for i in range(scores.shape[1])]
        sdata = ColumnarData(
            names=names,
            raw={n: np.asarray([f"{v:.4f}" for v in scores[:, i]], object)
                 for i, n in enumerate(names)},
            n_rows=scores.shape[0],
        )
        alg = spec["assembler"]
        paths = find_model_paths(os.path.join(self._assembler_dir(alg), "models"))
        runner = ModelRunner(paths, device=self.device)
        final = runner.score_raw(sdata).mean
        keep = tags >= 0
        perf = evaluate_performance(final[keep], tags[keep].astype(float))
        out_dir = self.paths.ensure(os.path.join(self.root, "evals", "Combo"))
        with open(os.path.join(out_dir, "EvalPerformance.json"), "w") as fh:
            json.dump(perf.to_json(), fh, indent=2)
        log.info("combo eval AUC %.6f -> %s", perf.area_under_roc, out_dir)
