"""`shifu eval` — score eval sets, confusion matrix, performance, gain chart
(counterpart of the in-memory path of `shifu_tpu/processor/evaluate.py`).

Parity: core/processor/EvalModelProcessor.java:138 — steps NEW/LIST/DELETE/
RUN/NORM/SCORE/CONFMAT/PERF (:155-170). RUN = score + confusion + perf +
gain chart. Score output column order parity with EvalScoreUDF:
tag|weight|mean|max|min|median|model0..modelN (+ scoreMetaColumns echo).

The eval set is read on the host, normalized or binned there (the value and
table norms on the device), each model scores it on the device, and the
aggregates, the score file, the sweep and the charts are numpy and text on
the host, formatted as the JAX package formats them. The `eval.*`
counters and gauges go to the obs registry, labeled by eval set, as in
the JAX package; `metrics` holds the last run's, read back by eval set
for the caller, beside the stage seconds of the last run (`timings`). An eval set
past `shifu.ingest.memoryBudgetMB`
(or `shifu.ingest.forceStreaming`) is scored chunk by chunk, appending to
the score file, with stream checkpoints and `--resume`; a score file past
the budget takes the streamed perf sweep and multi-class confusion.
Under a multi-host plan (`HostPlan`) the merge host runs the whole eval
and the other hosts skip: the score file is one append-order file, and
the host split pays in stats and norm.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict, List, Optional

import numpy as np

from shifu_tpu_torch.config.model_config import EvalConfig, RawSourceData
from shifu_tpu_torch.data.purify import combined_mask
from shifu_tpu_torch.data.reader import (
    make_tags_for,
    make_weights,
    read_columnar,
    read_header,
)
from shifu_tpu_torch.data.pipeline import HostPlan
from shifu_tpu_torch.data.stream import memory_budget_bytes, should_stream
from shifu_tpu_torch.eval.scorefile import (SCORE_COLUMN, SEP,
                                            iter_score_tables,
                                            read_score_file,
                                            read_score_header)
from shifu_tpu_torch.obs import registry
from shifu_tpu_torch.obs.metrics import _parse_key
from shifu_tpu_torch.processor.basic import BasicProcessor
from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike

log = get_logger(__name__)

SCORE_HEADER = ["tag", "weight", "mean", "max", "min", "median"]


def _score_names(widths: List[int]) -> List[str]:
    """model{i}, or model{i}_{k} for each class of a NATIVE multi-class
    model: model-major."""
    names: List[str] = []
    for i, w in enumerate(widths):
        if w == 1:
            names.append(f"model{i}")
        else:
            names.extend(f"model{i}_{k}" for k in range(w))
    return names


def _formatted(values: np.ndarray, spec: str) -> List[str]:
    """`f"{v:{spec}}"` of every value, as the JAX writer formats each numpy
    scalar (f32 and f64 alike go through the exact double)."""
    return list(map(f"{{:{spec}}}".format, values.tolist()))


def _score_rows(tags, weights, result, meta_cols) -> str:
    """The score file's rows of one scored block, each line ended."""
    if not len(tags):
        return ""
    columns = [result.mean, result.max, result.min, result.median,
               *result.model_scores.T]
    fields = ([list(map(str, tags.tolist())), _formatted(weights, "g")]
              + [_formatted(c, ".3f") for c in columns]
              # raw meta values must not smuggle the field separator
              + [[str(v).replace(SEP, " ") for v in vals]
                 for _, vals in meta_cols])
    return "\n".join(map(SEP.join, zip(*fields))) + "\n"


def eval_metrics(snap: dict) -> Dict[str, Dict[str, float]]:
    """{eval set: {records, records_pos, ..., auc, accuracy, ...}}: the
    `eval.*` counters and gauges of a registry snapshot, by their `eval`
    label."""
    out: Dict[str, Dict[str, float]] = {}
    for kind in ("counters", "gauges"):
        for key, v in snap[kind].items():
            name, labels = _parse_key(key)
            if name.startswith("eval.") and "eval" in labels:
                out.setdefault(labels["eval"], {})[name[len("eval."):]] = v
    return out


class EvalProcessor(BasicProcessor):
    step = "eval"

    def __init__(
        self,
        root: str = ".",
        new_name: Optional[str] = None,
        list_sets: bool = False,
        delete_name: Optional[str] = None,
        run_name: Optional[str] = None,
        score_name: Optional[str] = None,
        norm_name: Optional[str] = None,
        confmat_name: Optional[str] = None,
        perf_name: Optional[str] = None,
        device: DeviceLike = None,
        host_plan: Optional[HostPlan] = None,
    ):
        super().__init__(root, device=device)
        # an explicit HostPlan (in-process multi-host runs, tests);
        # None reads the lifecycle knobs
        self.host_plan = host_plan
        self.new_name = new_name
        self.list_sets = list_sets
        self.delete_name = delete_name
        self.run_name = run_name
        self.score_name = score_name
        self.norm_name = norm_name
        self.confmat_name = confmat_name
        self.perf_name = perf_name
        # seconds of each stage of the last run (read, normalize or codes,
        # forward, aggregate, reasons, write, perf) and the forwards'
        # device ms (cuda only); the last run's eval.* series by set
        self.timings: Dict[str, float] = {}
        self.metrics: Dict[str, Dict[str, float]] = {}

    # ---- eval-set management ----
    def _evals(self, name: str) -> List[EvalConfig]:
        mc = self.model_config
        assert mc is not None
        if name:
            e = mc.get_eval(name)
            if e is None:
                raise ShifuError(ErrorCode.INVALID_MODEL_CONFIG,
                                 f"eval set {name} not found")
            return [e]
        return list(mc.evals)

    def _add(self, key: str, value: float) -> None:
        self.timings[key] = self.timings.get(key, 0.0) + value

    def run_step(self) -> None:
        try:
            self._run_step()
        finally:
            # the run's eval.* series, kept for the caller once the
            # registry has moved on to the next step
            self.metrics = eval_metrics(registry().snapshot())

    def _run_step(self) -> None:
        hp = self.host_plan if self.host_plan is not None else HostPlan()
        if hp.active and not hp.is_merge_host:
            # one append-order score file: the merge host runs the whole
            # eval, the other hosts skip
            log.info("eval skipped on host %d/%d: the merge host runs the "
                     "full eval pass", hp.host_index, hp.n_hosts)
            return
        self.setup()
        mc = self.model_config
        assert mc is not None
        self.timings = {}

        if self.new_name is not None:
            ec = EvalConfig(name=self.new_name, data_set=RawSourceData())
            ec.data_set.data_path = mc.data_set.data_path
            ec.data_set.header_path = mc.data_set.header_path
            ec.data_set.data_delimiter = mc.data_set.data_delimiter
            ec.data_set.header_delimiter = mc.data_set.header_delimiter
            mc.evals.append(ec)
            self.save_model_config()
            log.info("eval set %s created; edit ModelConfig.json evals "
                     "section.", self.new_name)
            return
        if self.list_sets:
            for e in mc.evals:
                log.info("eval set: %s (%s)", e.name, e.data_set.data_path)
            return
        if self.delete_name is not None:
            mc.evals = [e for e in mc.evals if e.name != self.delete_name]
            self.save_model_config()
            shutil.rmtree(self.paths.eval_dir(self.delete_name),
                          ignore_errors=True)
            log.info("eval set %s deleted.", self.delete_name)
            return

        if self.score_name is not None:
            for e in self._evals(self.score_name):
                self._score(e)
            return
        if self.confmat_name is not None or self.perf_name is not None:
            name = (self.confmat_name if self.confmat_name is not None
                    else self.perf_name)
            for e in self._evals(name):
                self._perf_from_scores(e)
            return
        if self.norm_name is not None:
            for e in self._evals(self.norm_name):
                self._norm(e)
            return

        # default / -run: full evaluation
        for e in self._evals(self.run_name or ""):
            self._score(e)
            self._perf_from_scores(e)

    # ---- data loading ----
    def _load_eval_data(self, ec: EvalConfig):
        mc = self.model_config
        ds = ec.data_set
        header = ds.header_path or mc.data_set.header_path
        if header:
            names = read_header(self.resolve(header),
                                ds.header_delimiter
                                or mc.data_set.header_delimiter)
        else:
            names = [c.column_name for c in self.column_configs]
        data = read_columnar(
            self.resolve(ds.data_path or mc.data_set.data_path),
            names,
            delimiter=ds.data_delimiter or mc.data_set.data_delimiter,
            missing_values=tuple(mc.data_set.missing_or_invalid_values),
        )
        mask = combined_mask(ds.filter_expressions, data.raw, data.n_rows)
        data = data.select_rows(mask)
        pos = ec.pos_tags if ec.pos_tags is not None else mc.data_set.pos_tags
        neg = ec.neg_tags if ec.neg_tags is not None else mc.data_set.neg_tags
        target = mc.data_set.target_column_name
        tags = make_tags_for(mc, data.column(target), pos, neg)
        weights = make_weights(data, ds.weight_column_name
                               or mc.data_set.weight_column_name)
        return data, tags, weights

    def _score_meta_columns(self, ec: EvalConfig, data) -> List[tuple]:
        """(name, raw values) pairs for evalConfig.scoreMetaColumns — the
        reference echoes these raw columns into the score output
        (EvalScoreUDF meta column pass-through; EvalConfig.java
        scoreMetaColumnNameFile)."""
        path = ec.score_meta_column_name_file
        if not path:
            return []
        full = self.resolve(path)
        if not os.path.isfile(full):
            log.warning("scoreMetaColumns file %s not found; skipping", full)
            return []
        with open(full) as fh:
            names = [ln.strip() for ln in fh if ln.strip()
                     and not ln.strip().startswith("#")]
        out = []
        for name in names:
            if name in data.raw:
                out.append((name, data.column(name)))
            else:
                log.warning("scoreMetaColumns: column %s not in eval data",
                            name)
        return out

    # ---- steps ----
    def _score(self, ec: EvalConfig) -> None:
        from shifu_tpu_torch.eval.scorer import ModelRunner, find_model_paths

        paths = find_model_paths(self.paths.models_dir())
        if not paths:
            raise ShifuError(ErrorCode.MODEL_NOT_FOUND,
                             f"no models under {self.paths.models_dir()}")
        mc = self.model_config
        data_path = self.resolve(ec.data_set.data_path
                                 or mc.data_set.data_path)
        try:
            stream = should_stream(data_path)
        except OSError:  # unreadable size probe: assume in-memory path
            stream = False
        if stream:
            self._score_streaming(ec, paths)
            return
        t0 = time.perf_counter()
        data, tags, weights = self._load_eval_data(ec)
        t1 = time.perf_counter()
        self._add("read", t1 - t0)
        runner = ModelRunner(paths, device=self.device,
                             column_configs=self.column_configs,
                             model_config=self.model_config)
        result = None
        if data.n_rows:
            result = runner.score_raw(data)
            for k, v in runner.timings.items():
                self._add(k, v)
            score_names = _score_names(result.model_widths)
        else:  # header-only file: the perf step reads a zero-row table
            score_names = self._spec_score_names(runner)
        t2 = time.perf_counter()
        meta_cols = self._score_meta_columns(ec, data)
        reasons = self._reason_codes(ec, data)
        if reasons is not None:
            meta_cols.append(("reasons", ["^".join(r) for r in reasons]))
        t3 = time.perf_counter()
        self._add("reasons", t3 - t2)
        out = self.paths.eval_score_path(ec.name)
        self.paths.ensure(os.path.dirname(out))
        header = SCORE_HEADER + score_names + [name for name, _ in meta_cols]
        with open(out, "w") as fh:
            fh.write(SEP.join(header) + "\n")
            if result is not None:
                fh.write(_score_rows(tags, weights, result, meta_cols))
        self._add("write", time.perf_counter() - t3)
        n_pos = int((tags == 1).sum())
        n_neg = int((tags == 0).sum())
        self._record_score_metrics(ec.name, data.n_rows, n_pos, n_neg,
                                   len(paths))
        log.info("eval %s scored %d records (%d pos / %d neg) with %d "
                 "models -> %s", ec.name, data.n_rows, n_pos, n_neg,
                 len(paths), out)

    def _score_streaming(self, ec: EvalConfig, paths: List[str]) -> None:
        """Bounded-memory scoring: raw records stream in ingest chunks,
        each chunk is purified, tagged and scored on its own and its rows
        append to the score file — host memory is one chunk x (2 +
        prefetchChunks) whatever the eval set's size (Eval.pig's mapper
        envelope). The chunks divide over the ShardPlan with per-shard
        cursors; the score file is the shared state: a resume truncates
        it to the snapshotted byte offset, so rows written after the last
        snapshot are scored again."""
        from shifu_tpu_torch.data.pipeline import ShardPlan, prefetch_iter
        from shifu_tpu_torch.data.stream import iter_columnar_chunks
        from shifu_tpu_torch.eval.scorer import ModelRunner
        from shifu_tpu_torch.resilience import checkpoint as ckpt_mod
        from shifu_tpu_torch.resilience import faults

        mc = self.model_config
        ds = ec.data_set
        header = ds.header_path or mc.data_set.header_path
        if header:
            names = read_header(self.resolve(header),
                                ds.header_delimiter
                                or mc.data_set.header_delimiter)
        else:
            names = [c.column_name for c in self.column_configs]
        runner = ModelRunner(paths, device=self.device,
                             column_configs=self.column_configs,
                             model_config=self.model_config)
        pos = ec.pos_tags if ec.pos_tags is not None else mc.data_set.pos_tags
        neg = ec.neg_tags if ec.neg_tags is not None else mc.data_set.neg_tags
        target = mc.data_set.target_column_name
        reasoner = self._make_reasoner(ec)  # once a run, not a chunk
        out = self.paths.eval_score_path(ec.name)
        self.paths.ensure(os.path.dirname(out))

        # the merge host runs the whole eval (run_step sends the others
        # home), so the plan is one host's whatever the knobs say
        shard_plan = ShardPlan(device=self.device,
                               host=HostPlan(n_hosts=1, host_index=0))
        S = shard_plan.n_shards
        cursors = [-1] * S
        shard_rows = [0] * S
        ck = None
        meta: dict = {}
        if ckpt_mod.ckpt_stream_enabled():
            ck = ckpt_mod.ShardedStreamCheckpoint(
                ckpt_mod.ckpt_base(self.root, "eval", f"score-{ec.name}"),
                self._eval_stream_sha(ec, paths, S), S)
            if ckpt_mod.resume_requested():
                loaded = ck.load()
                if loaded is not None and os.path.isfile(out):
                    cursors = list(loaded[0])
                    shard_rows = [int(m.get("rows", 0))
                                  for _a, m, _b in loaded[1]]
                    meta = loaded[2][1]
                    faults.survived("preempt")
                    log.info("resuming eval %s (shard cursors %s, offset "
                             "%d)", ec.name, cursors, meta["offset"])
            else:
                ck.clear()
        n_rows = int(meta.get("nRows", 0))
        n_pos = int(meta.get("nPos", 0))
        n_neg = int(meta.get("nNeg", 0))
        wrote_header = bool(meta.get("wroteHeader", False))
        chunks = iter_columnar_chunks(
            self.resolve(ds.data_path or mc.data_set.data_path), names,
            delimiter=ds.data_delimiter or mc.data_set.data_delimiter,
            missing_values=tuple(mc.data_set.missing_or_invalid_values))
        t0 = time.perf_counter()
        with open(out, "r+" if meta else "w") as fh:
            if meta:
                fh.seek(int(meta["offset"]))
                fh.truncate()
            for ci, chunk in prefetch_iter(
                    shard_plan.resume_slice(enumerate(chunks), cursors)):
                faults.fault_point("chunk")
                mask = combined_mask(ds.filter_expressions, chunk.raw,
                                     chunk.n_rows)
                chunk = chunk.select_rows(mask)
                if not chunk.n_rows:
                    continue
                tags = make_tags_for(mc, chunk.column(target), pos, neg)
                weights = make_weights(
                    chunk, ds.weight_column_name
                    or mc.data_set.weight_column_name)
                result = runner.score_raw(chunk)
                for k, v in runner.timings.items():
                    self._add(k, v)
                meta_cols = self._score_meta_columns(ec, chunk)
                if reasoner is not None:
                    meta_cols.append(("reasons", [
                        "^".join(r) for r in reasoner.reason_codes(chunk)]))
                if not wrote_header:
                    fh.write(SEP.join(
                        SCORE_HEADER + _score_names(result.model_widths)
                        + [n for n, _ in meta_cols]) + "\n")
                    wrote_header = True
                fh.write(_score_rows(tags, weights, result, meta_cols))
                n_rows += chunk.n_rows
                n_pos += int((tags == 1).sum())
                n_neg += int((tags == 0).sum())
                shard = shard_plan.shard_of(ci)
                cursors[shard] = ci
                shard_rows[shard] += chunk.n_rows
                shard_plan.record(shard, chunk.n_rows, "eval.score")
                if ck is not None:
                    def _state(_fh=fh):
                        _fh.flush()
                        os.fsync(_fh.fileno())
                        return ([(cursors[s], None, {"rows": shard_rows[s]},
                                  None) for s in range(S)],
                                (None, {"offset": _fh.tell(),
                                        "nRows": n_rows, "nPos": n_pos,
                                        "nNeg": n_neg,
                                        "wroteHeader": wrote_header},
                                 None))
                    ck.maybe_save(_state)
            if not wrote_header:  # no rows: a header-only score table
                fh.write(SEP.join(SCORE_HEADER
                                  + self._spec_score_names(runner)) + "\n")
        if ck is not None:
            ck.clear()
        self._add("stream", time.perf_counter() - t0)
        self._record_score_metrics(ec.name, n_rows, n_pos, n_neg, len(paths))
        log.info("eval %s STREAMED %d records (%d pos / %d neg) with %d "
                 "models -> %s", ec.name, n_rows, n_pos, n_neg, len(paths),
                 out)

    def _record_score_metrics(self, name: str, n_rows: int, n_pos: int,
                              n_neg: int, n_models: int) -> None:
        reg = registry()
        reg.counter("eval.records", eval=name).inc(n_rows)
        reg.counter("eval.records_pos", eval=name).inc(n_pos)
        reg.counter("eval.records_neg", eval=name).inc(n_neg)
        reg.gauge("eval.models", eval=name).set(n_models)

    def _eval_stream_sha(self, ec: EvalConfig, paths: List[str],
                         n_shards: int) -> str:
        """Identity of a streamed score run: the models (names and
        sizes), the eval data source, the chunk geometry and shards."""
        from shifu_tpu_torch.data.stream import chunk_rows_setting
        from shifu_tpu_torch.resilience.checkpoint import config_sha

        return config_sha({
            "eval": ec.name,
            "models": [(os.path.basename(p), os.path.getsize(p))
                       for p in paths],
            "data": (ec.data_set.data_path
                     or self.model_config.data_set.data_path),
            "chunkRows": chunk_rows_setting(),
            "shards": int(n_shards),
        })

    @staticmethod
    def _spec_score_names(runner) -> List[str]:
        """Score column names derived from the model specs alone (needed
        when an eval set yields zero rows)."""
        from shifu_tpu_torch.models.nn import NNModelSpec
        from shifu_tpu_torch.models.tree import TreeModelSpec

        widths = []
        for spec in runner.specs:
            w = 1
            if isinstance(spec, NNModelSpec) and spec.out_dim > 1:
                w = spec.out_dim
            elif isinstance(spec, TreeModelSpec) and spec.n_classes >= 3:
                w = spec.n_classes
            widths.append(w)
        return _score_names(widths)

    def _make_reasoner(self, ec: EvalConfig):
        """Reasoner for the eval set's reasonCodePath, or None
        (core/Reasoner.java + CalculateReasonCodeUDF parity; needs
        posttrain's binAvgScore in ColumnConfig)."""
        path = (ec.custom_paths or {}).get("reasonCodePath")
        if not path:
            return None
        from shifu_tpu_torch.eval.reasoner import (Reasoner,
                                                   load_reason_code_map)

        full = self.resolve(path)
        try:
            code_map = load_reason_code_map(full)
        except (OSError, ValueError) as e:
            log.warning("reasonCodePath %s is unreadable (%s); reasons "
                        "fall back to raw column names", full, e)
            code_map = {}
        reasoner = Reasoner(self.column_configs, code_map)
        if not reasoner.columns:
            log.warning("reasonCodePath configured but no column has "
                        "binAvgScore — run `shifu posttrain` first")
            return None
        return reasoner

    def _reason_codes(self, ec: EvalConfig, data):
        reasoner = self._make_reasoner(ec)
        return reasoner.reason_codes(data) if reasoner is not None else None

    def _score_file(self, ec: EvalConfig) -> str:
        """The eval set's score file, scored first when there is none."""
        path = self.paths.eval_score_path(ec.name)
        if not os.path.isfile(path):
            self._score(ec)
        return path

    def _streamed_sweep(self, ec: EvalConfig, score_path: str,
                        score_col: str):
        """Tie-aware confusion sweep over a score file past the budget:
        chunked reads tally exact per-distinct-score sums (the file holds
        3 decimals, so distinct scores are few), then one small sort
        builds the sweep (ConfusionMatrix.bufferedComputeConfusionMatrix
        AndPerformance:248's externally sorted matrix)."""
        from shifu_tpu_torch.data.stream import chunk_rows_setting
        from shifu_tpu_torch.eval.metrics import sweep_from_histogram

        tally: dict = {}
        for table in iter_score_tables(score_path, [score_col],
                                       chunk_rows_setting()):
            if not len(table.tag):
                continue
            sc = table.columns[score_col].astype(np.float64)
            tg = table.tag.astype(np.float64)
            w = table.weight.astype(np.float64)
            uniq, inv = np.unique(sc, return_inverse=True)
            sums = [np.bincount(inv, weights=x, minlength=len(uniq))
                    for x in (tg, 1.0 - tg, tg * w, (1.0 - tg) * w)]
            for i, sv in enumerate(uniq.tolist()):
                acc = tally.setdefault(sv, [0.0, 0.0, 0.0, 0.0])
                for j in range(4):
                    acc[j] += sums[j][i]
        scores = np.asarray(list(tally.keys()), np.float64)
        agg = (np.asarray(list(tally.values()), np.float64) if tally
               else np.zeros((0, 4)))
        log.info("streamed perf sweep: %d distinct scores", len(scores))
        return sweep_from_histogram(scores, agg[:, 0], agg[:, 1],
                                    agg[:, 2], agg[:, 3])

    def _perf_from_scores(self, ec: EvalConfig) -> None:
        from shifu_tpu_torch.eval.gainchart import render_gain_chart
        from shifu_tpu_torch.eval.metrics import (
            confusion_matrix_rows,
            confusion_sweep,
            evaluate_performance_from_sweep,
        )

        mc = self.model_config
        if mc.is_multi_classification():
            self._multiclass_confusion(ec)
            return
        score_path = self._score_file(ec)
        t0 = time.perf_counter()
        selector = (ec.performance_score_selector or "mean").lower()
        score_col = (selector if selector in read_score_header(score_path)
                     else "mean")
        if os.path.getsize(score_path) > memory_budget_bytes():
            cs = self._streamed_sweep(ec, score_path, score_col)
        else:
            table = read_score_file(score_path, [score_col])
            cs = confusion_sweep(table.columns[score_col],
                                 table.tag.astype(np.float64), table.weight)

        perf = evaluate_performance_from_sweep(
            cs, n_buckets=ec.performance_bucket_num or 10
        )
        perf_path = self.paths.eval_performance_path(ec.name)
        self.paths.ensure(os.path.dirname(perf_path))
        with open(perf_path, "w") as fh:
            json.dump(perf.to_json(), fh, indent=2)

        rows = confusion_matrix_rows(cs)
        cm_path = self.paths.eval_confusion_path(ec.name)
        with open(cm_path, "w") as fh:
            if rows:
                cols = list(rows[0].keys())
                fh.write(",".join(cols) + "\n")
                for r in rows:
                    fh.write(",".join(f"{r[c]:.6g}" for c in cols) + "\n")

        chart = render_gain_chart(ec.name, mc.basic.name, perf)
        with open(self.paths.gain_chart_path(ec.name), "w") as fh:
            fh.write(chart)
        self._add("perf", time.perf_counter() - t0)
        reg = registry()
        reg.gauge("eval.auc", eval=ec.name).set(perf.area_under_roc)
        reg.gauge("eval.weighted_auc", eval=ec.name).set(
            perf.weighted_area_under_roc)
        log.info(
            "eval %s: AUC %.6f (weighted %.6f); perf -> %s, chart -> %s",
            ec.name, perf.area_under_roc, perf.weighted_area_under_roc,
            perf_path, self.paths.gain_chart_path(ec.name),
        )

    def _multiclass_confusion(self, ec: EvalConfig) -> None:
        """Multi-class eval: K x K confusion matrix + accuracy
        (ConfusionMatrix.computeConfusionMatixForMultipleClassification:625,
        prediction semantics in eval/multiclass.py). Replaces the binary
        PR/ROC/gain path, as runConfusionMatrix does in the reference."""
        from shifu_tpu_torch.eval.multiclass import (
            class_priors,
            confusion_matrix_multi,
            confusion_matrix_text,
            multiclass_accuracy,
            predict_native,
            predict_one_vs_all,
        )
        from shifu_tpu_torch.eval.scorer import DEFAULT_SCORE_SCALE

        mc = self.model_config
        # class list must match the tag indices _load_eval_data produced —
        # EvalConfig-level pos/neg overrides included
        pos = ec.pos_tags if ec.pos_tags is not None else mc.data_set.pos_tags
        neg = ec.neg_tags if ec.neg_tags is not None else mc.data_set.neg_tags
        class_tags = [str(t) for t in list(pos or []) + list(neg or [])]
        K = len(class_tags)
        score_path = self._score_file(ec)
        t0 = time.perf_counter()
        priors = self._training_class_priors(K)
        score_cols = [c for c in read_score_header(score_path)
                      if SCORE_COLUMN.match(c)]

        def scores_of(table):
            return (np.stack([table.columns[c] for c in score_cols], axis=1)
                    if score_cols else np.zeros((len(table.tag), 0)))

        def predict(scores):
            if mc.train.is_one_vs_all():
                return predict_one_vs_all(scores, priors,
                                          scale=DEFAULT_SCORE_SCALE)
            return predict_native(scores, K)

        if os.path.getsize(score_path) > memory_budget_bytes():
            # the K x K matrix is the only state: stream the score file
            # (the priors come from the norm meta; the eval set's own are
            # unknowable a chunk at a time)
            from shifu_tpu_torch.data.stream import chunk_rows_setting

            if priors is None:
                priors = np.full(K, 1.0 / K)
                log.warning("streamed multi-class confusion without "
                            "training classPriors (re-run `shifu norm`); "
                            "using uniform priors")
            matrix = np.zeros((K, K), np.int64)
            for table in iter_score_tables(score_path, score_cols,
                                           chunk_rows_setting()):
                if len(table.tag):
                    matrix += confusion_matrix_multi(
                        table.tag, predict(scores_of(table)), K)
        else:
            table = read_score_file(score_path, score_cols)
            if priors is None:
                priors = class_priors(table.tag, K)
            matrix = confusion_matrix_multi(table.tag,
                                            predict(scores_of(table)), K)
        cm_path = self.paths.eval_confusion_path(ec.name)
        self.paths.ensure(os.path.dirname(cm_path))
        with open(cm_path, "w") as fh:
            fh.write(confusion_matrix_text(matrix, class_tags))
        acc = multiclass_accuracy(matrix)
        reg = registry()
        reg.gauge("eval.accuracy", eval=ec.name).set(acc)
        reg.counter("eval.confusion_diagonal", eval=ec.name).inc(
            float(np.trace(matrix)))
        reg.counter("eval.confusion_offdiagonal", eval=ec.name).inc(
            float(matrix.sum() - np.trace(matrix)))
        perf_path = self.paths.eval_performance_path(ec.name)
        with open(perf_path, "w") as fh:
            json.dump({
                "version": "1.0",
                "classes": class_tags,
                "confusionMatrix": matrix.tolist(),
                "accuracy": acc,
                "classPriors": list(np.asarray(priors, float)),
            }, fh, indent=2)
        self._add("perf", time.perf_counter() - t0)
        log.info("eval %s multi-class (%d classes): accuracy %.4f; "
                 "confusion -> %s", ec.name, K, acc, cm_path)

    def _training_class_priors(self, n_classes: int):
        """Training-set class ratios recorded by `shifu norm` in meta.json
        (binRatio source — the reference reads per-class binCountPos/Neg
        from the target ColumnConfig)."""
        from shifu_tpu_torch.norm.dataset import read_meta

        try:
            meta = read_meta(self.paths.normalized_data_dir())
        except (OSError, ValueError, KeyError):  # no/old norm meta
            return None
        priors = (meta.extra or {}).get("classPriors")
        if priors and len(priors) == n_classes:
            return np.asarray(priors, np.float64)
        return None

    def _norm(self, ec: EvalConfig) -> None:
        """eval -norm: write the normalized eval matrix
        (EvalModelProcessor NORM step)."""
        from shifu_tpu_torch.norm.dataset import write_normalized
        from shifu_tpu_torch.norm.normalizer import (apply_norm_plan,
                                                     build_norm_plan)

        mc = self.model_config
        data, tags, weights = self._load_eval_data(ec)
        keep = tags >= 0  # invalid-tag rows are dropped, as in `shifu norm`
        data = data.select_rows(keep)
        tags, weights = tags[keep], weights[keep]
        plan = build_norm_plan(mc, self.column_configs)
        feats = apply_norm_plan(plan, data, device=self.device)
        out_dir = os.path.join(self.paths.eval_dir(ec.name), "NormalizedData")
        write_normalized(out_dir, feats, tags, weights,
                         plan.out_names, norm_type=mc.normalize.norm_type.value)
        log.info("eval %s normalized -> %s", ec.name, out_dir)
