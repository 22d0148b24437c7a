"""`shifu convert` — model spec format conversion (counterpart of
`shifu_tpu/processor/convert.py`).

Parity: util/IndependentTreeModelUtils.java:138 (`shifu convert` zip <->
binary spec). The native specs convert to and from a readable JSON form,
and out to the reference's own formats:
    -tozip     binary (.nn/.lr/.gbt/.rf/.wdl) -> .json
    -tobin     .json -> binary spec
    -toref     NN -> BinaryNNSerializer .nn, GBT/RF -> BinaryDTSerializer,
               WDL -> BinaryWDLSerializer (NN and WDL need the model set's
               ColumnConfig.json for the embedded column stats)
    -toeg      NN -> Encog EG text
    -tozipref  GBT/RF -> the reference zip spec
    -fromref   load a reference spec and report what it is

The JSON holds the JAX package's keys with the same values, plus what
its `-tobin` drops (the errors, a tree set's F_0, class count and
leaf-wise pointers, a WDL's norm type and cutoff; ROADMAP C.12), so
-tozip then -tobin gives back the original file byte for byte; the
JAX package's JSON converts too, with its defaults for what it lacks.
Host only: no device.
"""

from __future__ import annotations

import json
import os

import numpy as np

from shifu_tpu_torch.processor.basic import BasicProcessor
from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

MODES = ("toref", "toeg", "tozipref", "fromref")


class ConvertProcessor(BasicProcessor):
    step = "convert"
    host_only = True

    def __init__(self, root: str = ".", to_json: bool = True,
                 input_path: str = None, output_path: str = None,
                 mode: str = None):
        super().__init__(root)
        self.to_json = to_json
        self.input_path = input_path
        self.output_path = output_path
        self.mode = mode  # toref | toeg | tozipref | fromref | None

    @classmethod
    def from_args(cls, args) -> "ConvertProcessor":
        mode = next((m for m in MODES if getattr(args, m, False)), None)
        return cls(to_json=not args.tobin, input_path=args.input,
                   output_path=args.output, mode=mode)

    def run_step(self) -> None:
        if not self.input_path:
            raise ShifuError(ErrorCode.INVALID_MODEL_CONFIG,
                             "convert needs an input model path")
        if self.mode in ("toref", "toeg", "tozipref"):
            self._to_reference(fmt={"toref": "binary", "toeg": "eg",
                                    "tozipref": "zip"}[self.mode])
        elif self.mode == "fromref":
            self._from_reference()
        elif self.to_json:
            self._to_json()
        else:
            self._to_binary()

    def _project_configs(self, what: str) -> float:
        """Load the model set's configs (the reference containers embed
        per-column stats); returns the norm cutoff."""
        try:
            self.setup()
        except Exception:
            raise ShifuError(
                ErrorCode.INVALID_COLUMN_CONFIG,
                f"-toref for {what} needs ModelConfig/ColumnConfig in cwd",
            )
        return self.model_config.normalize.std_dev_cut_off or 4.0

    def _to_reference(self, fmt: str) -> None:
        """Export a native spec into the reference's model formats
        (BinaryNNSerializer.java:46 / BinaryDTSerializer.java:62 /
        IndependentTreeModelUtils.java:40 zip / BinaryWDLSerializer)."""
        from shifu_tpu_torch.compat.adapters import (
            nn_spec_to_eg_bytes,
            nn_spec_to_egb_bytes,
            tree_spec_to_ref_bytes,
            tree_spec_to_zip_bytes,
        )
        from shifu_tpu_torch.eval.scorer import load_model
        from shifu_tpu_torch.models.nn import NNModelSpec
        from shifu_tpu_torch.models.tree import TreeModelSpec
        from shifu_tpu_torch.models.wdl import WDLModelSpec

        spec = load_model(self.input_path)
        suffix = os.path.splitext(self.input_path)[1]
        if isinstance(spec, NNModelSpec):
            if fmt == "eg":
                blob = nn_spec_to_eg_bytes(spec)
            else:
                cutoff = self._project_configs(
                    "NN (use -toeg for a standalone Encog text export)")
                blob = nn_spec_to_egb_bytes(spec, self.column_configs,
                                            cutoff=cutoff)
            out = self.output_path or self.input_path + ".ref.nn"
        elif isinstance(spec, TreeModelSpec):
            if fmt == "zip":
                blob = tree_spec_to_zip_bytes(spec)
                out = self.output_path or self.input_path + ".zip"
            else:
                blob = tree_spec_to_ref_bytes(spec)
                out = self.output_path or self.input_path + f".ref{suffix}"
        elif isinstance(spec, WDLModelSpec):
            from shifu_tpu_torch.compat import wdl as cwdl

            cutoff = self._project_configs(
                "WDL (the container embeds per-column stats)")
            blob = cwdl.write_wdl_model(cwdl.wdl_spec_to_ref(
                spec, self.column_configs, cutoff=cutoff))
            out = self.output_path or self.input_path + ".ref.wdl"
        else:
            raise ShifuError(
                ErrorCode.MODEL_NOT_FOUND,
                f"cannot export {self.input_path} to reference format")
        with open(out, "wb") as fh:
            fh.write(blob)
        log.info("exported %s -> %s (reference %s format)",
                 self.input_path, out, fmt)

    def _from_reference(self) -> None:
        """Report on a reference spec; reference models score directly via
        `shifu eval` (the scorer sniffs formats), so import validates."""
        from shifu_tpu_torch.compat.adapters import load_ref_model

        adapter = load_ref_model(self.input_path)
        if adapter is None:
            raise ShifuError(ErrorCode.MODEL_NOT_FOUND,
                             f"{self.input_path} is not a reference-format "
                             "spec")
        log.info("loaded reference spec %s: kind=%s algorithm=%s",
                 self.input_path, adapter.kind, adapter.algorithm)

    def _to_json(self) -> None:
        from shifu_tpu_torch.eval.scorer import load_model
        from shifu_tpu_torch.models.nn import NNModelSpec, flatten_params
        from shifu_tpu_torch.models.tree import TreeModelSpec
        from shifu_tpu_torch.models.wdl import WDLModelSpec, flatten_wdl

        spec = load_model(self.input_path)
        out = self.output_path or self.input_path + ".json"
        if isinstance(spec, NNModelSpec):
            head = spec.header()
            flat, shapes = flatten_params(spec.params)
            head["layerShapes"] = [list(s) for s in shapes]
            head["weights"] = [float(x) for x in flat]
        elif isinstance(spec, TreeModelSpec):
            head = {
                "algorithm": spec.algorithm,
                "inputColumns": spec.input_columns,
                "slots": spec.slots,
                "boundaries": spec.boundaries,
                "categories": spec.categories,
                "loss": spec.loss,
                "learningRate": spec.learning_rate,
                "convertToProb": spec.convert_to_prob,
                "trees": [_tree_json(t) for t in spec.trees],
                "initPred": spec.init_pred,
                "trainError": spec.train_error,
                "validError": spec.valid_error,
                "nClasses": spec.n_classes,
            }
        elif isinstance(spec, WDLModelSpec):
            head = {
                "algorithm": "WDL", "hidden": spec.hidden,
                "activations": spec.activations, "embedDim": spec.embed_dim,
                "denseColumns": spec.dense_columns,
                "catColumns": spec.cat_columns,
                "vocabSizes": spec.vocab_sizes,
                "normSpecs": spec.norm_specs,
                "categories": spec.categories,
                "weights": [float(x) for x in flatten_wdl(spec.params)],
                "normCutoff": spec.norm_cutoff,
                "normType": spec.norm_type,
                "trainError": spec.train_error,
                "validError": spec.valid_error,
            }
        else:
            raise ShifuError(ErrorCode.MODEL_NOT_FOUND,
                             f"cannot convert {self.input_path} to JSON")
        head["sourceFormat"] = os.path.splitext(self.input_path)[1]
        with open(out, "w") as fh:
            json.dump(head, fh)
        log.info("converted %s -> %s", self.input_path, out)

    def _to_binary(self) -> None:
        with open(self.input_path) as fh:
            head = json.load(fh)
        alg = head.get("algorithm", "NN")
        out = self.output_path
        if alg in ("GBT", "RF"):
            from shifu_tpu_torch.models.tree import TreeModelSpec

            spec = TreeModelSpec(
                algorithm=alg, trees=[_tree_from_json(t)
                                      for t in head["trees"]],
                input_columns=head.get("inputColumns", []),
                slots=head.get("slots", []),
                boundaries=head.get("boundaries", []),
                categories=head.get("categories", []),
                loss=head.get("loss", "squared"),
                learning_rate=float(head.get("learningRate", 0.05)),
                convert_to_prob=head.get("convertToProb", "SIGMOID"),
                init_pred=float(head.get("initPred", 0.0)),
                train_error=head.get("trainError"),
                valid_error=head.get("validError"),
                n_classes=int(head.get("nClasses", 0)),
            )
            out = out or f"model_converted.{alg.lower()}"
        elif alg == "WDL":
            from shifu_tpu_torch.models.wdl import WDLModelSpec, unflatten_wdl

            spec = WDLModelSpec(
                hidden=head["hidden"], activations=head["activations"],
                embed_dim=head["embedDim"],
                dense_columns=head["denseColumns"],
                cat_columns=head["catColumns"],
                vocab_sizes=head["vocabSizes"],
                norm_specs=head.get("normSpecs", []),
                norm_cutoff=float(head.get("normCutoff", 4.0)),
                categories=head.get("categories", []),
                norm_type=head.get("normType", "ZSCALE"),
                train_error=head.get("trainError"),
                valid_error=head.get("validError"),
            )
            spec.params = unflatten_wdl(
                np.asarray(head["weights"], np.float32), spec.template())
            out = out or "model_converted.wdl"
        else:
            from shifu_tpu_torch.models.nn import (NNModelSpec,
                                                   unflatten_params)

            spec = NNModelSpec(
                layer_sizes=head["layerSizes"],
                activations=head["activations"],
                out_activation=head.get("outActivation", "sigmoid"),
                input_columns=head.get("inputColumns", []),
                norm_type=head.get("normType", "ZSCALE"),
                algorithm=head.get("algorithm", "NN"),
                loss=head.get("loss", "squared"),
                norm_specs=head.get("normSpecs", []),
                norm_cutoff=float(head.get("normCutoff", 4.0)),
                train_error=head.get("trainError"),
                valid_error=head.get("validError"),
                class_tags=head.get("classTags", []),
            )
            spec.params = unflatten_params(
                np.asarray(head["weights"], np.float32),
                [tuple(s) for s in head["layerShapes"]],
            )
            out = out or f"model_converted{head.get('sourceFormat', '.nn')}"
        spec.save(out)
        log.info("converted %s -> %s", self.input_path, out)


def _tree_json(t) -> dict:
    out = {
        "weight": t.weight,
        "feature": t.feature.tolist(),
        "leftMask": t.left_mask.astype(int).tolist(),
        "leafValue": [float(v) for v in t.leaf_value],
    }
    if not t.is_dense_layout:  # leaf-wise: the explicit child pointers
        out["left"] = t.left.tolist()
        out["right"] = t.right.tolist()
    return out


def _tree_from_json(t: dict):
    from shifu_tpu_torch.models.tree import DenseTree

    ptr = {k: np.asarray(t[k], np.int32) for k in ("left", "right")
           if k in t}
    return DenseTree(
        feature=np.asarray(t["feature"], np.int32),
        left_mask=np.asarray(t["leftMask"], bool),
        leaf_value=np.asarray(t["leafValue"], np.float32),
        weight=float(t["weight"]), **ptr)
