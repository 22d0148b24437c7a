"""`python -m shifu_tpu_torch` — the port's CLI (counterpart of
`shifu_tpu/cli.py`).

    python -m shifu_tpu_torch init [--device cpu|cuda] [-Dk=v ...]
    python -m shifu_tpu_torch stats [-correlation] [-psi] [-rebin] [--resume]
                                    [--device cpu|cuda] [-Dk=v ...]
    python -m shifu_tpu_torch norm [-shuffle] [--resume] [--device cpu|cuda]
                                   [-Dk=v ...]
    python -m shifu_tpu_torch varsel [-list] [-reset] [-recover]
                                     [--device cpu|cuda] [-Dk=v ...]
    python -m shifu_tpu_torch train [-dry] [--resume] [--device cpu|cuda]
                                    [-Dk=v ...]
    python -m shifu_tpu_torch posttrain [--device cpu|cuda] [-Dk=v ...]
    python -m shifu_tpu_torch eval [-new NAME|-list|-delete NAME|-run [NAME]|
                                   -score [NAME]|-perf [NAME]|-confmat [NAME]|
                                   -norm [NAME]] [--resume]
                                   [--device cpu|cuda] [-Dk=v ...]
    python -m shifu_tpu_torch serve [--host H] [--port P] [--models-dir D]
                                    [--replicas N] [--batching MODE]
                                    [--queue-depth N] [--max-batch-rows N]
                                    [--max-wait-ms MS] [--warm SIZES]
                                    [--device cpu|cuda] [-Dk=v ...]
    python -m shifu_tpu_torch new NAME [-t NN|LR|GBT|RF|...]
    python -m shifu_tpu_torch export [-t pmml|onebagging|columnstats|corr|
                                     woemapping] [-c]
    python -m shifu_tpu_torch encode [-d EVALSET] [--device cpu|cuda]
    python -m shifu_tpu_torch combo [-new ALGS] [-init] [-run] [-eval]
                                    [--device cpu|cuda]
    python -m shifu_tpu_torch save [VERSION] | switch VERSION | show
    python -m shifu_tpu_torch test [-n N] | analysis | version
    python -m shifu_tpu_torch convert [-tozip|-tobin|-toref|-toeg|
                                      -tozipref|-fromref] INPUT [OUTPUT]
    python -m shifu_tpu_torch runs [--last N] [--step S] [--diff A B]
                                   [--resumable] [--traces] [--json]
    python -m shifu_tpu_torch profile [STEP] [--last N] [--diff A B] [--json]
    python -m shifu_tpu_torch trace [--last N] [--slowest N [--stage S]]
                                    [--show ID] [--fleet [--out P]] [--json]
    python -m shifu_tpu_torch top [--url URL] [--interval S] [--once]
                                  [--json]

run in a model-set directory. The flags follow the JAX subcommands;
`--device` picks the device (default: the card, an error without one);
`new`, `export`, `save`, `switch`, `show`, `test`, `analysis`,
`convert`, `version` and the run-ledger readers `trace`, `top`, `runs`
and `profile` touch no device and take none.
`normalize` and `varselect` are aliases of `norm` and `varsel`. Exit
codes follow the JAX CLI: 0 ok, 1 ShifuError (or no card), 2 not
implemented. Every other lifecycle subcommand exits 2 with the ROADMAP
item that ports it, and so do the routes of a ported step that wait
(the streamed norm, trainers and eval, varsel's VOTED filter, serve's
`--zoo` and `--traffic-log`).
-Dk=v anywhere on the line sets an operational property
(ShifuCLI.java:430-453).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from shifu_tpu_torch.resilience.faults import PreemptionError
from shifu_tpu_torch.utils import environment
from shifu_tpu_torch.utils.errors import ShifuError
from shifu_tpu_torch.utils.log import configure, get_logger
from shifu_tpu_torch.utils.platform import DeviceUnavailable

log = get_logger("shifu")

# the JAX CLI's other subcommands and the ROADMAP item that ports each
NOT_PORTED = {"retrain": "A.14", "promote": "A.14", "check": "A.14"}


def _extract_props(argv: List[str]) -> List[str]:
    """Pull -Dk=v args out (anywhere on the line) into the environment."""
    rest = []
    for arg in argv:
        if arg.startswith("-D") and "=" in arg:
            key, value = arg[2:].split("=", 1)
            environment.set_property(key, value)
        else:
            rest.append(arg)
    return rest


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m shifu_tpu_torch",
        description="shifu lifecycle steps ported to PyTorch/CUDA",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    sub = parser.add_subparsers(dest="command")
    device_help = "device to run on (default: cuda)"
    resume_help = ("resume a preempted streamed run from its last stream "
                   "checkpoint")
    p_init = sub.add_parser("init", help="initialize ColumnConfig.json "
                                         "from the data header")
    p_init.add_argument("--device", choices=["cpu", "cuda"], default=None,
                        help=device_help)
    p_stats = sub.add_parser("stats", help="compute column statistics and "
                                           "binning")
    p_stats.add_argument("-correlation", "--correlation",
                         action="store_true")
    p_stats.add_argument("-psi", "--psi", action="store_true")
    p_stats.add_argument("-rebin", "--rebin", action="store_true")
    p_stats.add_argument("--resume", action="store_true", help=resume_help)
    p_stats.add_argument("--device", choices=["cpu", "cuda"], default=None,
                         help=device_help)
    p_norm = sub.add_parser("norm", aliases=["normalize"],
                            help="normalize training data")
    p_norm.add_argument("-shuffle", "--shuffle", action="store_true")
    p_norm.add_argument("--resume", action="store_true", help=resume_help)
    p_norm.add_argument("--device", choices=["cpu", "cuda"], default=None,
                        help=device_help)
    p_varsel = sub.add_parser("varsel", aliases=["varselect"],
                              help="variable selection")
    p_varsel.add_argument("-list", "--list", action="store_true",
                          dest="list_vars")
    p_varsel.add_argument("-reset", "--reset", action="store_true")
    p_varsel.add_argument("-recover", "--recover", action="store_true")
    p_varsel.add_argument("--device", choices=["cpu", "cuda"], default=None,
                          help=device_help)
    p_train = sub.add_parser("train", help="train model(s)")
    p_train.add_argument("-dry", "--dry", action="store_true", help="dry run")
    p_train.add_argument("--resume", action="store_true",
                         help=resume_help + " (the tree step resumes "
                              "from its per-tree checkpoint either way)")
    p_train.add_argument("--device", choices=["cpu", "cuda"], default=None,
                         help=device_help)
    p_post = sub.add_parser("posttrain", help="post-train bin metrics and "
                                              "feature importance")
    p_post.add_argument("--device", choices=["cpu", "cuda"], default=None,
                        help=device_help)
    p_eval = sub.add_parser("eval", help="evaluate model(s)")
    p_eval.add_argument("-new", dest="new_name", default=None,
                        help="create eval set")
    p_eval.add_argument("-list", action="store_true", dest="list_sets")
    p_eval.add_argument("-delete", dest="delete_name", default=None)
    for flag in ("run", "score", "norm", "confmat", "perf"):
        p_eval.add_argument(f"-{flag}", dest=f"{flag}_name", nargs="?",
                            const="", default=None)
    p_eval.add_argument("--resume", action="store_true", help=resume_help)
    p_eval.add_argument("--device", choices=["cpu", "cuda"], default=None,
                        help=device_help)
    p_serve = sub.add_parser(
        "serve", help="online scoring (HTTP: POST /score, GET /healthz; "
                      "one scoring replica per card behind a drain-aware "
                      "router)")
    p_serve.add_argument("--host", default="127.0.0.1")
    p_serve.add_argument("--port", type=int, default=8080,
                         help="listen port (0 = ephemeral, printed on "
                              "stdout)")
    p_serve.add_argument("--models-dir", default=None, dest="models_dir",
                         help="model spec dir (default: <root>/models)")
    p_serve.add_argument("--replicas", type=int, default=None,
                         help="scoring replicas (default "
                              "-Dshifu.serve.replicas; 0 = one per card)")
    p_serve.add_argument("--batching", default=None,
                         choices=["continuous", "barrier"],
                         help="micro-batch close policy (default "
                              "continuous)")
    p_serve.add_argument("--queue-depth", type=int, default=None,
                         dest="queue_depth",
                         help="admission queue depth a replica (default "
                              "128; beyond it requests shed with 429)")
    p_serve.add_argument("--max-batch-rows", type=int, default=None,
                         dest="max_batch_rows",
                         help="micro-batch row cap (default 1024)")
    p_serve.add_argument("--max-wait-ms", type=float, default=None,
                         dest="max_wait_ms",
                         help="barrier-mode micro-batch deadline in ms "
                              "(default 2.0)")
    p_serve.add_argument("--warm", default=None,
                         help="comma-separated batch sizes to run once at "
                              "startup (e.g. 1,16,256)")
    p_serve.add_argument("--traffic-log", nargs="?", const="1.0",
                         default=None, dest="traffic_log", metavar="SAMPLE",
                         help="not ported yet (ROADMAP A.14)")
    p_serve.add_argument("--zoo", action="append", default=None,
                         metavar="NAME=PATH[,NAME=PATH...]",
                         help="not ported yet (ROADMAP A.14)")
    p_serve.add_argument("--device", choices=["cpu", "cuda"], default=None,
                         help=device_help)
    p_new = sub.add_parser("new", help="create a new model set")
    p_new.add_argument("name")
    p_new.add_argument("-t", "--type", default="NN",
                       help="algorithm (NN/LR/GBT/RF/WDL)")
    p_export = sub.add_parser("export", help="export model (pmml, "
                                             "columnstats, ...)")
    p_export.add_argument("-t", "--type", default="pmml")
    p_export.add_argument("-c", "--concise", action="store_true")
    p_combo = sub.add_parser("combo", help="ensemble-of-algorithms workflow")
    p_combo.add_argument("-new", dest="new_algs", default=None,
                         help="e.g. NN,GBT,LR")
    p_combo.add_argument("-init", action="store_true", dest="do_init")
    p_combo.add_argument("-run", action="store_true", dest="do_run")
    p_combo.add_argument("-eval", action="store_true", dest="do_eval")
    p_combo.add_argument("--device", choices=["cpu", "cuda"], default=None,
                         help=device_help)
    p_encode = sub.add_parser("encode", help="encode dataset with a trained "
                                             "model")
    p_encode.add_argument("-d", "--dataset", default=None)
    p_encode.add_argument("--device", choices=["cpu", "cuda"], default=None,
                          help=device_help)
    p_test = sub.add_parser("test", help="dry-run filter expressions on "
                                         "sample rows")
    p_test.add_argument("-n", type=int, default=100)
    sub.add_parser("analysis", help="model/data analysis report")
    p_save = sub.add_parser("save", help="save current model-set version")
    p_save.add_argument("version", nargs="?")
    p_switch = sub.add_parser("switch", help="switch model-set version")
    p_switch.add_argument("version")
    sub.add_parser("show", help="show model-set versions")
    sub.add_parser("version", help="print version")
    p_convert = sub.add_parser("convert", help="convert model spec formats")
    p_convert.add_argument("-tozip", action="store_true")
    p_convert.add_argument("-tobin", action="store_true")
    p_convert.add_argument("-toref", action="store_true",
                           help="export to the reference's binary spec "
                                "(EGB .nn / BinaryDTSerializer .gbt/.rf / "
                                "BinaryWDLSerializer .wdl)")
    p_convert.add_argument("-toeg", action="store_true",
                           help="export an NN model to Encog EG text")
    p_convert.add_argument("-tozipref", action="store_true",
                           help="export a tree model to the reference zip "
                                "spec")
    p_convert.add_argument("-fromref", action="store_true",
                           help="load a reference spec and report its kind")
    p_convert.add_argument("input", nargs="?")
    p_convert.add_argument("output", nargs="?")
    p_trace = sub.add_parser(
        "trace", help="inspect captured request traces "
                      "(.shifu/runs/serve-<seq>.traces.json: per-stage "
                      "timelines, Perfetto-loadable; captured by `shifu "
                      "serve` head sampling / slow-tail capture)")
    p_trace.add_argument("--last", type=int, default=None,
                         help="show only the N most recent traces "
                              "(default 10)")
    p_trace.add_argument("--slowest", type=int, default=None,
                         metavar="N",
                         help="show the N slowest traces by total ms "
                              "(or by one stage's ms with --stage)")
    p_trace.add_argument("--stage", default=None,
                         choices=["featurize", "route", "queue",
                                  "coalesce", "device", "d2h",
                                  "serialize"],
                         help="with --slowest: rank by this stage's "
                              "summed duration instead of the total")
    p_trace.add_argument("--show", default=None, metavar="ID",
                         help="print one trace's full per-stage "
                              "timeline (searches all trace files, "
                              "newest first)")
    p_trace.add_argument("--fleet", action="store_true",
                         help="stitch EVERY run/process trace file "
                              "under .shifu/runs into ONE Perfetto "
                              "export (.shifu/runs/fleet.traces.json) "
                              "with a track group per process — a "
                              "fleet promote round renders as one "
                              "cross-process timeline")
    p_trace.add_argument("--out", default=None, metavar="PATH",
                         help="with --fleet: stitched export path")
    p_trace.add_argument("--json", action="store_true", dest="as_json",
                         help="emit the selected trace summaries as "
                              "JSON")

    p_top = sub.add_parser(
        "top", help="terminal dashboard over one serve process: polls "
                    "its /metrics + /healthz and renders QPS, per-stage "
                    "p50/p99, SLO burn and breaker states")
    p_top.add_argument("--url", default="http://127.0.0.1:8080",
                       help="the serve process's base URL (default "
                            "http://127.0.0.1:8080)")
    p_top.add_argument("--interval", type=float, default=2.0,
                       help="poll/refresh interval in seconds "
                            "(default 2)")
    p_top.add_argument("--once", action="store_true",
                       help="render ONE frame and exit (no screen "
                            "clear; for scripts and CI)")
    p_top.add_argument("--json", action="store_true", dest="as_json",
                       help="with --once: print the polled payload as "
                            "JSON")

    p_runs = sub.add_parser(
        "runs", help="list run-ledger manifests (.shifu/runs)")
    p_runs.add_argument("--last", type=int, default=None,
                        help="show only the N most recent runs")
    p_runs.add_argument("--step", default=None,
                        help="filter by lifecycle step (stats/norm/train/...)")
    p_runs.add_argument("--diff", nargs=2, metavar=("A", "B"), default=None,
                        help="diff two manifests' metric snapshots "
                             "(counters/gauges); A/B are step-seq ids "
                             "(train-3), step names (newest run), or "
                             "manifest paths")
    p_runs.add_argument("--json", action="store_true", dest="as_json",
                        help="dump the selected manifests as JSON")
    p_runs.add_argument("--resumable", action="store_true",
                        help="list mid-stream checkpoints a preempted "
                             "step left under .shifu/runs/ckpt (resume "
                             "with `shifu <step> --resume`)")
    p_runs.add_argument("--traces", action="store_true",
                        help="add a TRACES column (captured count + "
                             "slowest ms) so serve-run listings point "
                             "at their request-trace evidence "
                             "(`shifu trace`)")

    p_prof = sub.add_parser(
        "profile", help="per-seam cost/roofline tables from "
                        "run-ledger manifests; --diff gates on "
                        "per-program regressions (exit 1 on breach)")
    p_prof.add_argument("step", nargs="?", default=None,
                        help="lifecycle step to show (default: all)")
    p_prof.add_argument("--last", type=int, default=None,
                        help="show only the N most recent runs "
                             "(default 1 with a step, else 5)")
    p_prof.add_argument("--diff", nargs=2, metavar=("A", "B"), default=None,
                        help="compare two runs program-by-program; A/B as "
                             "in `shifu runs --diff`. Exit 1 when a "
                             "per-dispatch cost metric regresses beyond "
                             "its threshold")
    p_prof.add_argument("--flops-pct", type=float, default=None,
                        dest="flops_pct",
                        help="max tolerated per-dispatch FLOPs increase %% "
                             "(default 10; also -Dshifu.profile.diff."
                             "flopsPct)")
    p_prof.add_argument("--bytes-pct", type=float, default=None,
                        dest="bytes_pct",
                        help="max tolerated bytes-accessed increase %% "
                             "(default 25)")
    p_prof.add_argument("--hbm-pct", type=float, default=None,
                        dest="hbm_pct",
                        help="max tolerated peak-HBM increase %% "
                             "(default 25)")
    p_prof.add_argument("--seconds-pct", type=float, default=None,
                        dest="seconds_pct",
                        help="max tolerated device-seconds increase %% "
                             "(default 0 = timing not gated)")
    p_prof.add_argument("--json", action="store_true", dest="as_json",
                        help="emit profile sections (or the diff rows) "
                             "as JSON")

    for name in NOT_PORTED:
        p = sub.add_parser(name, help=f"not ported yet (ROADMAP "
                                      f"{NOT_PORTED[name]})")
        p.add_argument("rest", nargs=argparse.REMAINDER)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    argv = _extract_props(argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    configure(getattr(args, "verbose", False))

    if args.command is None:
        parser.print_help()
        return 1
    resume = getattr(args, "resume", False)
    if resume:
        environment.set_property("shifu.resume", "true")
    try:
        return dispatch(args)
    except ShifuError as e:
        log.error("%s", e)
        return 1
    except DeviceUnavailable as e:
        log.error("%s (use --device cpu)", e)
        return 1
    except NotImplementedError as e:
        log.error("not implemented yet: %s", e)
        return 2
    except PreemptionError as e:
        log.error("preempted: %s (rerun with --resume)", e)
        return 1
    finally:
        if resume:
            environment.set_property("shifu.resume", "")


def dispatch(args: argparse.Namespace) -> int:
    cmd = args.command
    if cmd == "init":
        from shifu_tpu_torch.processor.init import InitProcessor

        return InitProcessor(device=args.device).run()
    if cmd == "stats":
        from shifu_tpu_torch.processor.stats import StatsProcessor

        return StatsProcessor(correlation=args.correlation, psi=args.psi,
                              rebin=args.rebin, device=args.device).run()
    if cmd in ("norm", "normalize"):
        from shifu_tpu_torch.processor.norm import NormProcessor

        return NormProcessor(shuffle=args.shuffle, device=args.device).run()
    if cmd in ("varsel", "varselect"):
        from shifu_tpu_torch.processor.varsel import VarSelProcessor

        return VarSelProcessor(list_vars=args.list_vars, reset=args.reset,
                               recover=args.recover,
                               device=args.device).run()
    if cmd == "train":
        from shifu_tpu_torch.processor.train import TrainProcessor

        return TrainProcessor(dry=args.dry, device=args.device).run()
    if cmd == "posttrain":
        from shifu_tpu_torch.processor.posttrain import PostTrainProcessor

        return PostTrainProcessor(device=args.device).run()
    if cmd == "eval":
        from shifu_tpu_torch.processor.evaluate import EvalProcessor

        return EvalProcessor(
            new_name=args.new_name, list_sets=args.list_sets,
            delete_name=args.delete_name, run_name=args.run_name,
            score_name=args.score_name, norm_name=args.norm_name,
            confmat_name=args.confmat_name, perf_name=args.perf_name,
            device=args.device).run()
    if cmd == "serve":
        return serve(args)
    if cmd == "version":
        import shifu_tpu_torch

        print(shifu_tpu_torch.__version__)
        return 0
    if cmd == "new":
        from shifu_tpu_torch.processor.create import run_new

        return run_new(args.name, args.type)
    if cmd == "export":
        from shifu_tpu_torch.processor.export import ExportProcessor

        return ExportProcessor(kind=args.type, concise=args.concise).run()
    if cmd == "combo":
        from shifu_tpu_torch.processor.combo import ComboProcessor

        return ComboProcessor.from_args(args).run()
    if cmd == "encode":
        from shifu_tpu_torch.processor.encode import EncodeProcessor

        return EncodeProcessor(dataset=args.dataset,
                               device=args.device).run()
    if cmd == "test":
        from shifu_tpu_torch.processor.testdata import TestDataProcessor

        return TestDataProcessor(n=args.n).run()
    if cmd == "analysis":
        from shifu_tpu_torch.processor.analysis import AnalysisProcessor

        return AnalysisProcessor().run()
    if cmd == "convert":
        from shifu_tpu_torch.processor.convert import ConvertProcessor

        return ConvertProcessor.from_args(args).run()
    if cmd == "trace":
        import json

        from shifu_tpu_torch.obs.ledger import runs_dir
        from shifu_tpu_torch.obs.reqtrace import (
            FLEET_TRACE_BASENAME,
            format_trace_detail,
            format_trace_table,
            load_trace_file,
            slowest_summaries,
            stitch_trace_files,
            trace_files,
        )

        files = trace_files(".")
        if not files:
            print("(no trace files under .shifu/runs — serve with "
                  "-Dshifu.trace.sample>0, -Dshifu.trace.slowMs>0 or an "
                  "X-Shifu-Trace header, then shut down cleanly)")
            return 0
        if args.fleet:
            out_path = args.out or os.path.join(runs_dir("."),
                                                FLEET_TRACE_BASENAME)
            doc = stitch_trace_files(files, out_path)
            if doc is None:
                log.error("trace --fleet: none of %d trace file(s) "
                          "were readable", len(files))
                return 2
            summ = doc["summary"]
            if args.as_json:
                print(json.dumps({"file": out_path, "summary": summ},
                                 indent=2, sort_keys=True))
            else:
                print(f"stitched {summ['count']} trace(s) from "
                      f"{len(summ['sources'])} file(s) -> {out_path}")
                for src in summ["sources"]:
                    print(f"  {src['label']:<28} {src['traces']:>5} "
                          f"trace(s)")
                print("open it in Perfetto (ui.perfetto.dev) for the "
                      "per-process track groups")
            return 0
        if args.show:
            for path in files:
                try:
                    doc = load_trace_file(path)
                except (OSError, ValueError):
                    continue
                for s in doc.get("shifuTraces", []):
                    if s.get("id") == args.show:
                        if args.as_json:
                            print(json.dumps(s, indent=2, sort_keys=True))
                        else:
                            print(format_trace_detail(s, path=path))
                        return 0
            log.error("trace id %s not found in %d trace file(s)",
                      args.show, len(files))
            return 1
        # the listing reads EVERY run/process trace file (newest file
        # first), not just the newest run's — a fleet leaves one file
        # per process behind
        summaries = []
        read_files = []
        captured = dropped = 0
        for path in files:
            try:
                doc = load_trace_file(path)
            except (OSError, ValueError) as e:
                log.warning("trace: cannot read %s: %s", path, e)
                continue
            read_files.append(path)
            summaries.extend(doc.get("shifuTraces", []))
            summ = doc.get("summary") or {}
            captured += int(summ.get("count") or 0)
            dropped += int(summ.get("dropped") or 0)
        if not read_files:
            log.error("trace: none of %d trace file(s) were readable",
                      len(files))
            return 2
        if args.slowest is not None:
            summaries = slowest_summaries(summaries, args.slowest,
                                          stage=args.stage)
        else:
            summaries = summaries[:args.last
                                  if args.last is not None else 10]
        if args.as_json:
            print(json.dumps({"files": read_files,
                              "captured": captured,
                              "dropped": dropped,
                              "traces": summaries},
                             indent=2, sort_keys=True))
        else:
            print(f"{len(read_files)} trace file(s), {captured} "
                  f"trace(s), dropped {dropped}")
            print(format_trace_table(summaries))
        return 0
    if cmd == "top":
        from shifu_tpu_torch.obs.top import run_top

        return run_top(args.url, interval_s=args.interval,
                       once=args.once, as_json=args.as_json)
    if cmd == "runs":
        import json

        from shifu_tpu_torch.obs.ledger import format_runs, list_runs

        if args.resumable:
            from shifu_tpu_torch.resilience.checkpoint import list_resumable

            entries = list_resumable(".")
            if args.as_json:
                print(json.dumps(entries, indent=2, sort_keys=True))
            elif not entries:
                print("(no resumable stream checkpoints under "
                      ".shifu/runs/ckpt)")
            else:
                print(f"{'STREAM':<24} {'CHUNK':>6} {'BYTES':>10} "
                      f"CONFIG-SHA")
                coresident = False
                for e in entries:
                    if e.get("corrupt"):
                        print(f"{e['name']:<24} {'?':>6} "
                              f"{e['bytes']:>10} (corrupt)")
                    elif e.get("family") == "coresident":
                        # an evicted co-resident trainer snapshot: one
                        # aggregated row for the whole per-stage family
                        coresident = True
                        print(f"{e['name']:<24} {'-':>6} "
                              f"{e['bytes']:>10} {e['configSha']} "
                              f"(coresident epoch={e.get('epoch')} "
                              f"stages={e.get('stages')})")
                    else:
                        print(f"{e['name']:<24} {e['chunkIndex']:>6} "
                              f"{e['bytes']:>10} {e['configSha']}")
                print("resume with: shifu <step> --resume")
                if coresident:
                    print("coresident rows resume with: shifu retrain "
                          "--coresident --resume (same stage count — a "
                          "changed -Dshifu.coresident.stages rejects "
                          "the snapshot and starts fresh)")
            return 0
        if args.diff:
            from shifu_tpu_torch.obs.profile import (
                diff_metric_snapshots,
                render_diff,
                resolve_manifest,
            )

            try:
                ma = resolve_manifest(".", args.diff[0])
                mb = resolve_manifest(".", args.diff[1])
            except (OSError, ValueError) as e:
                log.error("runs --diff: %s", e)
                return 2
            rows = diff_metric_snapshots(ma, mb)
            if args.as_json:
                print(json.dumps(rows, indent=2, sort_keys=True))
            else:
                print(render_diff(
                    f"metrics diff: {ma.get('step')}-{ma.get('seq')} -> "
                    f"{mb.get('step')}-{mb.get('seq')}", rows))
            return 0
        manifests = list_runs(".", last=args.last, step=args.step)
        if args.as_json:
            print(json.dumps(manifests, indent=2, sort_keys=True))
        else:
            print(format_runs(manifests, show_traces=args.traces))
        return 0
    if cmd == "profile":
        import json

        from shifu_tpu_torch.obs.ledger import list_runs
        from shifu_tpu_torch.obs.profile import (
            diff_profiles,
            format_profile,
            render_diff,
            resolve_manifest,
        )

        if args.diff:
            try:
                ma = resolve_manifest(".", args.diff[0])
                mb = resolve_manifest(".", args.diff[1])
            except (OSError, ValueError) as e:
                log.error("profile --diff: %s", e)
                return 2
            rows, breaches = diff_profiles(ma, mb, {
                "flopsPct": args.flops_pct,
                "bytesPct": args.bytes_pct,
                "hbmPct": args.hbm_pct,
                "secondsPct": args.seconds_pct,
            })
            if args.as_json:
                print(json.dumps({"rows": rows, "breaches": breaches},
                                 indent=2, sort_keys=True))
            else:
                print(render_diff(
                    f"profile diff: {ma.get('step')}-{ma.get('seq')} -> "
                    f"{mb.get('step')}-{mb.get('seq')}", rows, breaches))
            return 1 if breaches else 0
        last = args.last if args.last is not None else (
            1 if args.step else 5)
        manifests = list_runs(".", last=last, step=args.step)
        if not manifests:
            print("(no runs recorded under .shifu/runs)")
            return 0
        if args.as_json:
            print(json.dumps(
                [{"step": m.get("step"), "seq": m.get("seq"),
                  "path": m.get("path"), "profile": m.get("profile")}
                 for m in manifests], indent=2, sort_keys=True))
        else:
            print("\n\n".join(format_profile(m) for m in manifests))
        return 0
    if cmd in ("save", "switch", "show"):
        from shifu_tpu_torch.processor.manage import ManageProcessor

        return ManageProcessor(cmd, getattr(args, "version", None)).run()
    raise NotImplementedError(
        f"`{cmd}` is not ported yet: ROADMAP {NOT_PORTED[cmd]}")


def serve(args: argparse.Namespace) -> int:
    """The JAX CLI's serve branch: parse --warm before binding the port,
    print `listening on HOST:PORT (N replica(s))` on stdout, drain on
    SIGINT/SIGTERM on a helper thread."""
    import signal
    import threading

    from shifu_tpu_torch.analysis import sanitize
    from shifu_tpu_torch.serve.server import ScoringServer

    if args.zoo or args.traffic_log is not None:
        flag = "--zoo" if args.zoo else "--traffic-log"
        raise NotImplementedError(
            f"serve {flag} is not ported yet: ROADMAP A.14")
    try:
        # -Dshifu.sanitize=race: parsed (a bad mode fails here) before the
        # server exists, so its race-tracked locks are built armed
        san = sanitize.from_environment()
        sizes = ([int(s) for s in args.warm.split(",") if s.strip()]
                 if args.warm else [])
        server = ScoringServer(
            root=".", models_dir=args.models_dir, host=args.host,
            port=args.port, queue_depth=args.queue_depth,
            max_batch_rows=args.max_batch_rows,
            max_wait_ms=args.max_wait_ms, replicas=args.replicas,
            batching=args.batching, device=args.device)
    except (ValueError, OSError, RuntimeError, ShifuError) as e:
        # a bad --warm, no models, a taken port, no card: before
        # "listening"
        log.error("serve: %s", e)
        return 1
    if sizes:
        log.info("warmed row buckets: %s", server.registry.warm(sizes))

    def _stop(signum, frame):
        log.info("signal %d: draining and shutting down", signum)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    # the bound port on stdout is the contract for scripted callers
    print(f"listening on {server.host}:{server.port} "
          f"({len(server.registry.replicas)} replica(s))", flush=True)
    # the sanitizer scope of the whole serving run: the shutdown manifest
    # embeds its shifu.sanitize/1 verdict
    with sanitize.activate(san):
        server.serve_forever()
    return 0
