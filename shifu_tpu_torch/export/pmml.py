"""PMML 4.2 export for NN/LR and GBT/RF models.

The port's own copy of `shifu_tpu/export/pmml.py`: the same code over the
port's `NNModelSpec` and `TreeModelSpec`, so one model file gives the same
document bytes in both packages. Tree documents follow dense (level-order)
trees by 2i+1/2i+2 and leaf-wise trees by their explicit child pointers.

Parity: core/pmml/PMMLTranslator.java:47 and its element creators
(DataDictionary, MiningSchema, NeuralNetwork, Zscore/Woe
LocalTransformations creators).
The generated document embeds the normalization as LocalTransformations:
  value kind  -> z-score as a DerivedField with NormContinuous (two
                 LinearNorm anchor points encode (x-mean)/std with outlier
                 clamp semantics)
  table kind  -> MapValues over an InlineTable (bin -> woe/posrate value)
so any PMML consumer (jpmml etc.) reproduces shifu-tpu scores from RAW data.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import List

import numpy as np

from shifu_tpu_torch.models.nn import NNModelSpec

PMML_NS = "http://www.dmg.org/PMML-4_2"


def _el(parent, tag, **attrs):
    e = ET.SubElement(parent, tag)
    for k, v in attrs.items():
        e.set(k, str(v))
    return e


def _derived_name(col: str) -> str:
    return f"norm_{col}"


def _add_local_transformations(parent, spec: NNModelSpec):
    lt = _el(parent, "LocalTransformations")
    for cd in spec.norm_specs:
        name = cd["name"]
        df = _el(lt, "DerivedField", name=_derived_name(name),
                 dataType="double", optype="continuous")
        if cd["kind"] == "value":
            mean, std = cd.get("mean", 0.0), cd.get("std", 1.0)
            std = std if abs(std) > 1e-5 else 1.0
            cutoff = spec.norm_cutoff
            nc = _el(df, "NormContinuous", field=name, outliers="asExtremeValues",
                     mapMissingTo=f"{0.0 if cd.get('zscore', True) else cd.get('fill', 0.0)}")
            # two anchors encode the affine map: x=mean -> 0, x=mean+std -> 1,
            # extreme values clamp at ±cutoff
            lo, hi = mean - cutoff * std, mean + cutoff * std
            _el(nc, "LinearNorm", orig=lo, norm=-cutoff)
            _el(nc, "LinearNorm", orig=hi, norm=cutoff)
        else:  # table
            table = cd.get("table") or []
            mv = _el(df, "MapValues", outputColumn="out",
                     dataType="double",
                     mapMissingTo=f"{table[-1] if table else 0.0}",
                     defaultValue=f"{table[-1] if table else 0.0}")
            _el(mv, "FieldColumnPair", field=name, column="in")
            inline = _el(mv, "InlineTable")
            cats = cd.get("categories")
            if cats:
                for cat, val in zip(cats, table):
                    row = _el(inline, "row")
                    ET.SubElement(row, "in").text = str(cat)
                    ET.SubElement(row, "out").text = f"{val}"
            else:
                # numeric binned table: discretize first via intervals
                bounds = cd.get("boundaries") or []
                df.remove(mv)
                disc = _el(df, "Discretize", field=name,
                           mapMissingTo=f"{table[-1] if table else 0.0}",
                           defaultValue=f"{table[-1] if table else 0.0}")
                for i in range(len(bounds)):
                    left = bounds[i]
                    right = bounds[i + 1] if i + 1 < len(bounds) else None
                    bin_el = _el(disc, "DiscretizeBin",
                                 binValue=f"{table[i] if i < len(table) else 0.0}")
                    iv = _el(bin_el, "Interval", closure="closedOpen")
                    if np.isfinite(left):
                        iv.set("leftMargin", str(left))
                    if right is not None and np.isfinite(right):
                        iv.set("rightMargin", str(right))
    return lt


def _nn_data_dictionary(root, spec: NNModelSpec):
    dd = _el(root, "DataDictionary")
    for cd in spec.norm_specs:
        optype = "categorical" if cd.get("categories") else "continuous"
        dtype = "string" if cd.get("categories") else "double"
        _el(dd, "DataField", name=cd["name"], optype=optype, dataType=dtype)
    _el(dd, "DataField", name="TARGET", optype="categorical", dataType="string")
    dd.set("numberOfFields", str(len(spec.norm_specs) + 1))
    return dd


def nn_to_pmml(spec: NNModelSpec, model_name: str = "shifu_tpu_model") -> str:
    if not spec.norm_specs:
        # the NeuralInputs/Con graph hangs off the norm columns: without
        # them the export would be a weight-less NeuralNetwork that
        # evaluators accept and score garbage with — fail loudly instead
        raise ValueError(
            "PMML export needs spec.norm_specs (the normalization plan "
            "that defines the model's input fields); this spec has none")
    root = ET.Element("PMML", version="4.2", xmlns=PMML_NS)
    header = _el(root, "Header", description="shifu-tpu exported model")
    _el(header, "Application", name="shifu-tpu", version="0.1")
    _nn_data_dictionary(root, spec)
    _nn_model_element(root, spec, model_name)
    ET.indent(root)
    return ET.tostring(root, encoding="unicode", xml_declaration=True)


def _nn_model_element(parent, spec: NNModelSpec, model_name: str):
    """The NeuralNetwork element itself — embeddable under a PMML root or
    a MiningModel Segment (one-bagging export)."""
    act = (spec.activations[0] if spec.activations else "tanh").lower()
    pmml_act = {"tanh": "tanh", "sigmoid": "logistic", "relu": "rectifier",
                "linear": "identity"}.get(act, "tanh")
    nn = _el(parent, "NeuralNetwork", modelName=model_name,
             functionName="regression", activationFunction=pmml_act)

    ms = _el(nn, "MiningSchema")
    for cd in spec.norm_specs:
        _el(ms, "MiningField", name=cd["name"], usageType="active")
    _el(ms, "MiningField", name="TARGET", usageType="target")

    out = _el(nn, "Output")
    of = _el(out, "OutputField", name="shifu_score", feature="predictedValue")

    _add_local_transformations(nn, spec)

    inputs = _el(nn, "NeuralInputs",
                 numberOfInputs=str(len(spec.norm_specs)))
    for i, cd in enumerate(spec.norm_specs):
        ni = _el(inputs, "NeuralInput", id=f"0,{i}")
        df = _el(ni, "DerivedField", dataType="double", optype="continuous")
        _el(df, "FieldRef", field=_derived_name(cd["name"]))

    params = spec.params
    prev_ids = [f"0,{i}" for i in range(len(spec.norm_specs))]
    for li, layer in enumerate(params):
        W, b = np.asarray(layer["W"]), np.asarray(layer["b"])
        is_output = li == len(params) - 1
        lay = _el(nn, "NeuralLayer",
                  activationFunction="logistic" if is_output else pmml_act)
        ids = []
        for j in range(W.shape[1]):
            neuron = _el(lay, "Neuron", id=f"{li + 1},{j}", bias=f"{b[j]}")
            for i, pid in enumerate(prev_ids):
                _el(neuron, "Con", **{"from": pid, "weight": f"{W[i, j]}"})
            ids.append(f"{li + 1},{j}")
        prev_ids = ids

    outputs = _el(nn, "NeuralOutputs", numberOfOutputs="1")
    no = _el(outputs, "NeuralOutput", outputNeuron=prev_ids[0])
    df = _el(no, "DerivedField", dataType="double", optype="continuous")
    _el(df, "FieldRef", field="TARGET")
    return nn


# ---------------------------------------------------------------------------
# Tree-ensemble PMML (GBT/RF)
# Parity: core/pmml TreeEnsemblePmmlCreator.java (MiningModel +
# Segmentation of per-tree TreeModels), TreeNodePmmlElementCreator (split
# predicates over RAW values), MiningModelPmmlCreator.
# ---------------------------------------------------------------------------


def _predicate_for(el, tree, spec, node_idx: int, go_left: bool):
    """Attach the predicate that routes a row into this child.

    Split translation back to RAW values:
      numeric f, ordered cut rank r  ->  left iff x < boundaries[r+1]
        (bin i covers [b_i, b_{i+1}); numeric splits keep code order and
        missing always routes right — BinUtils.getNumericalBinIndex)
      categorical f -> left iff value in {categories[i] : left_mask[i]};
        the right child carries the complement set (missing is handled by
        missingValueStrategy=defaultChild on the parent).
    """
    feature = int(tree.feature[node_idx])
    name = spec.input_columns[feature]
    cats = spec.categories[feature] if feature < len(spec.categories) else None
    mask = tree.left_mask[node_idx]
    if cats:
        # the isIn side is chosen so UNSEEN categories (present, not in
        # either training set — they bin to the missing slot natively)
        # follow the missing slot's routing via the isNotIn complement
        missing_left = len(cats) < len(mask) and bool(mask[len(cats)])
        in_side_left = not missing_left
        members = [
            str(cats[i]) for i in range(len(cats))
            if (i < len(mask) and bool(mask[i])) == in_side_left
        ]
        ssp = _el(el, "SimpleSetPredicate", field=name,
                  booleanOperator="isIn" if go_left == in_side_left
                  else "isNotIn")
        arr = _el(ssp, "Array", type="string", n=str(len(members)))
        # PMML Array quoting: backslash-escape embedded quotes/backslashes
        arr.text = " ".join(
            '"' + c.replace("\\", "\\\\").replace('"', '\\"') + '"'
            for c in members
        )
        return
    bounds = spec.boundaries[feature] or []
    real = [i for i in range(min(len(bounds), len(mask))) if mask[i]]
    cut = (max(real) if real else -1) + 1
    if cut < len(bounds):
        thr = float(bounds[cut])
        _el(el, "SimplePredicate", field=name,
            operator="lessThan" if go_left else "greaterOrEqual",
            value=f"{thr}")
    else:  # left = every real value; only missing goes right
        _el(el, "SimplePredicate", field=name,
            operator="isNotMissing" if go_left else "isMissing")


def _missing_goes_left(tree, spec, node_idx: int) -> bool:
    feature = int(tree.feature[node_idx])
    cats = spec.categories[feature] if feature < len(spec.categories) else None
    mask = tree.left_mask[node_idx]
    if cats:
        return len(cats) < len(mask) and bool(mask[len(cats)])
    return False  # numeric missing bin is the last slot, never in the prefix


def _tree_nodes(tree, spec, parent, node_idx: int, node_id_prefix: str,
                fold_weight: float, predicate=None):
    """Emit one PMML Node (recursively) for DenseTree node `node_idx`.
    `predicate(el)` attaches this node's routing predicate (True at root)."""
    node = _el(parent, "Node", id=f"{node_id_prefix}{node_idx}",
               score=f"{float(tree.leaf_value[node_idx]) * fold_weight}")
    if predicate is None:
        _el(node, "True")
    else:
        predicate(node)
    feature = int(tree.feature[node_idx])
    if feature < 0:  # leaf
        return node
    dense = tree.is_dense_layout
    li = int(tree.left[node_idx]) if not dense else 2 * node_idx + 1
    ri = int(tree.right[node_idx]) if not dense else 2 * node_idx + 2
    _tree_nodes(tree, spec, node, li, node_id_prefix, fold_weight,
                lambda el, n=node_idx: _predicate_for(el, tree, spec, n, True))
    _tree_nodes(tree, spec, node, ri, node_id_prefix, fold_weight,
                lambda el, n=node_idx: _predicate_for(el, tree, spec, n, False))
    default = li if _missing_goes_left(tree, spec, node_idx) else ri
    node.set("defaultChild", f"{node_id_prefix}{default}")
    return node


def _tree_data_dictionary(root, spec):
    dd = _el(root, "DataDictionary")
    for j, name in enumerate(spec.input_columns):
        cats = spec.categories[j] if j < len(spec.categories) else None
        _el(dd, "DataField", name=name,
            optype="categorical" if cats else "continuous",
            dataType="string" if cats else "double")
    _el(dd, "DataField", name="TARGET", optype="categorical",
        dataType="string")
    dd.set("numberOfFields", str(len(spec.input_columns) + 1))
    return dd


def _scaled_output(mm):
    """RawResult + FinalResult 0..1 -> 0..1000 (golden golf0.pmml Output)."""
    out = _el(mm, "Output")
    _el(out, "OutputField", name="RawResult", optype="continuous",
        dataType="double", feature="predictedValue")
    fr = _el(out, "OutputField", name="FinalResult", optype="continuous",
             dataType="double", feature="transformedValue")
    ncont = _el(fr, "NormContinuous", field="RawResult")
    _el(ncont, "LinearNorm", orig="0.0", norm="0.0")
    _el(ncont, "LinearNorm", orig="1.0", norm="1000.0")
    return out


def _tree_mining_model_element(parent, spec, model_name: str,
                               with_output: bool = True):
    """The tree-ensemble MiningModel element itself — embeddable under a
    PMML root or a one-bagging Segment."""
    hybrid_cols = [
        name for j, name in enumerate(spec.input_columns)
        if (spec.categories[j] if j < len(spec.categories) else None)
        and (spec.boundaries[j] if j < len(spec.boundaries) else None)
    ]
    if hybrid_cols:
        raise ValueError(
            "PMML export does not support hybrid (H) columns yet — their "
            "combined numeric+category bin axis has no faithful single "
            f"PMML predicate; columns: {hybrid_cols}"
        )

    mm = _el(parent, "MiningModel", modelName=model_name,
             functionName="regression")
    ms = _el(mm, "MiningSchema")
    for name in spec.input_columns:
        _el(ms, "MiningField", name=name, usageType="active")
    _el(ms, "MiningField", name="TARGET", usageType="target")
    if with_output:
        _scaled_output(mm)

    is_gbt = spec.algorithm.upper() == "GBT"
    seg = _el(mm, "Segmentation",
              multipleModelMethod="sum" if is_gbt else "average")
    for k, tree in enumerate(spec.trees):
        segment = _el(seg, "Segment", id=f"Segement{k}", weight=f"{tree.weight}")
        _el(segment, "True")
        tm = _el(segment, "TreeModel", modelName=str(k),
                 functionName="regression",
                 missingValueStrategy="defaultChild",
                 splitCharacteristic="binarySplit")
        tms = _el(tm, "MiningSchema")
        for name in spec.input_columns:
            _el(tms, "MiningField", name=name, usageType="active")
        fold = tree.weight if is_gbt else 1.0
        _tree_nodes(tree, spec, tm, 0, f"{model_name}t{k}n", fold)
    return mm


def tree_to_pmml(spec, model_name: str = "shifu_tpu_model") -> str:
    """TreeModelSpec -> PMML MiningModel with one TreeModel Segment per tree
    (TreeEnsemblePmmlCreator.convert). GBT folds each tree's weight into its
    leaf scores and sums segments (exact weighted-sum semantics); RF
    averages equal-weight segments. Log-loss GBT emits RAW logits — the
    sigmoid conversion happens scorer-side, like the reference's
    gbtScoreConvertStrategy."""
    root = ET.Element("PMML", version="4.2", xmlns=PMML_NS)
    header = _el(root, "Header", description="shifu-tpu exported tree model")
    _el(header, "Application", name="shifu-tpu", version="0.1")
    _tree_data_dictionary(root, spec)
    _tree_mining_model_element(root, spec, model_name)
    ET.indent(root)
    return ET.tostring(root, encoding="unicode", xml_declaration=True)


def bagged_to_pmml(specs: List, model_name: str = "shifu_tpu_model") -> str:
    """One-bagging PMML (ExportModelProcessor.java:173): every bagged model
    becomes one Segment of a top-level averaging MiningModel, so a single
    PMML document scores like `shifu eval`'s mean aggregation. NN segments
    embed full NeuralNetwork elements (with their LocalTransformations,
    sigmoid outputs included); tree bags embed nested MiningModels.

    Constraints for a SELF-CONTAINED document: all bags must share one
    model family and column set, and GBT bags must use RAW score
    conversion — PMML has no sigmoid output transform, so a SIGMOID-
    converting GBT cannot be averaged faithfully inside the document
    (score it via `shifu eval` or per-model PMML + scorer-side
    conversion instead)."""
    from shifu_tpu_torch.models.tree import TreeModelSpec

    if not specs:
        raise ValueError("no models to export")
    first = specs[0]
    if not isinstance(first, (NNModelSpec, TreeModelSpec)):
        raise ValueError(
            "one-bagging PMML needs NATIVE NN/LR/GBT/RF specs; "
            f"got {type(first).__name__} (convert reference-format models "
            "with `shifu convert -fromref` semantics first)")
    same_type = all(isinstance(s, type(first)) for s in specs)
    if not same_type:
        raise ValueError(
            "one-bagging PMML needs a single model family per document "
            f"(got {sorted({type(s).__name__ for s in specs})})")
    if isinstance(first, NNModelSpec):
        cols = [cd["name"] for cd in first.norm_specs]
        for s in specs[1:]:
            if [cd["name"] for cd in s.norm_specs] != cols:
                raise ValueError("one-bagging PMML needs identical input "
                                 "columns across bags")
    else:
        cols = list(first.input_columns)
        for s in specs[1:]:
            if list(s.input_columns) != cols:
                raise ValueError("one-bagging PMML needs identical input "
                                 "columns across bags")
        for s in specs:
            if (s.algorithm.upper() == "GBT"
                    and (s.loss == "log" or s.convert_to_prob == "SIGMOID")):
                raise ValueError(
                    "one-bagging PMML cannot express the GBT sigmoid score "
                    "conversion inside the document; use squared-loss/RAW "
                    "GBT, or export per-model PMML and convert scorer-side")

    root = ET.Element("PMML", version="4.2", xmlns=PMML_NS)
    header = _el(root, "Header",
                 description="shifu-tpu one-bagging export")
    _el(header, "Application", name="shifu-tpu", version="0.1")

    if isinstance(first, NNModelSpec):
        _nn_data_dictionary(root, first)
        field_names = cols
    else:
        _tree_data_dictionary(root, first)
        field_names = cols

    mm = _el(root, "MiningModel", modelName=model_name,
             functionName="regression")
    ms = _el(mm, "MiningSchema")
    for name in field_names:
        _el(ms, "MiningField", name=name, usageType="active")
    _el(ms, "MiningField", name="TARGET", usageType="target")
    _scaled_output(mm)

    seg = _el(mm, "Segmentation", multipleModelMethod="average")
    for b, spec in enumerate(specs):
        segment = _el(seg, "Segment", id=f"bag{b}")
        _el(segment, "True")
        if isinstance(spec, NNModelSpec):
            _nn_model_element(segment, spec, f"{model_name}_bag{b}")
        else:
            _tree_mining_model_element(segment, spec,
                                       f"{model_name}_bag{b}",
                                       with_output=False)
    ET.indent(root)
    return ET.tostring(root, encoding="unicode", xml_declaration=True)
