"""Reference tree-ensemble binary/zip model-spec compatibility
(counterpart of `shifu_tpu/compat/treespec.py`; numpy on the host).

Byte-compatible reader/writer for the reference's GBT/RF model specs:

* binary ``model*.gbt`` / ``model*.rf`` written by
  core/dtrain/dt/BinaryDTSerializer.java:62 (gzip, version 4; older
  uncompressed v<=3 streams read too) and loaded by
  dt/IndependentTreeModel.loadFromStream (IndependentTreeModel.java:966);
* zip spec (entries ``model.ini`` Jackson JSON + ``trees``) produced by
  util/IndependentTreeModelUtils.java:40 (``shifu convert``).

Scoring mirrors IndependentTreeModel.compute (:352) / predictNode (:516)
vectorized over rows: each node routes its row subset with one boolean
mask instead of per-row pointer chasing.
"""

from __future__ import annotations

import gzip
import io
import json
import zipfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from shifu_tpu_torch.compat.javaio import JavaDataInput, JavaDataOutput

TREE_FORMAT_VERSION = 4  # CommonConstants.TREE_FORMAT_VERSION
CONTINUOUS = 1  # FeatureType.CONTINUOUS byte
CATEGORICAL = 2  # FeatureType.CATEGORICAL byte
MAX_CATEGORICAL_VAL_LEN = 10 * 1024  # Constants.MAX_CATEGORICAL_VAL_LEN
GROUP_DELIMITER = "@^"  # Constants.CATEGORICAL_GROUP_VAL_DELIMITER
ROOT_INDEX = 1  # Node.ROOT_INDEX


@dataclass
class RefSplit:
    column_num: int
    feature_type: int  # CONTINUOUS | CATEGORICAL
    threshold: float = 0.0
    is_left: bool = False
    categories: Optional[np.ndarray] = None  # short indices in the bitset


@dataclass
class RefNode:
    id: int
    gain: float = 0.0
    wgt_cnt: float = 0.0
    split: Optional[RefSplit] = None
    predict: Optional[float] = None
    class_value: int = 0
    left: Optional["RefNode"] = None
    right: Optional["RefNode"] = None

    @property
    def is_real_leaf(self) -> bool:
        return self.left is None and self.right is None


@dataclass
class RefTree:
    tree_id: int
    node_num: int
    root: RefNode
    learning_rate: float = 1.0
    root_wgt_cnt: float = 0.0
    features: List[int] = field(default_factory=list)


@dataclass
class RefTreeModel:
    """In-memory image of the reference IndependentTreeModel."""

    algorithm: str  # GBT | RF
    loss: str
    is_classification: bool
    is_one_vs_all: bool
    input_node: int
    numerical_mean: Dict[int, float]
    column_names: Dict[int, str]  # columnNum -> name
    categorical_values: Dict[int, List[str]]  # columnNum -> merged bin categories
    column_mapping: Dict[int, int]  # columnNum -> input array index
    bags: List[List[RefTree]]
    version: int = TREE_FORMAT_VERSION

    # -- derived -------------------------------------------------------------
    def category_index(self, column_num: int) -> Dict[str, int]:
        """Flattened category -> bin index (merged @^ groups share an index,
        parity IndependentTreeModel.loadFromStream:1016)."""
        out: Dict[str, int] = {}
        for j, cat in enumerate(self.categorical_values.get(column_num, [])):
            if GROUP_DELIMITER in cat:
                for piece in cat.split(GROUP_DELIMITER):
                    out[piece] = j
            else:
                out[cat] = j
        return out

    def weights(self) -> List[List[float]]:
        return [[t.learning_rate for t in bag] for bag in self.bags]

    # -- scoring -------------------------------------------------------------
    def data_matrix(self, rows: List[Dict[str, object]]) -> np.ndarray:
        """Raw (columnName -> value) maps -> dense [n, inputs] array,
        parity convertDataMapToDoubleArray (IndependentTreeModel.java:571)."""
        n = len(rows)
        data = np.zeros((n, len(self.column_mapping)), dtype=np.float64)
        cat_idx = {c: self.category_index(c) for c in self.categorical_values}
        for col_num, idx in self.column_mapping.items():
            name = self.column_names.get(col_num)
            if col_num in self.categorical_values:
                size = len(self.categorical_values[col_num])
                table = cat_idx[col_num]
                for i, row in enumerate(rows):
                    obj = row.get(name)
                    j = table.get(str(obj), size) if obj is not None else size
                    data[i, idx] = j if 0 <= j <= size else size
            else:
                mean = self.numerical_mean.get(col_num, 0.0) or 0.0
                for i, row in enumerate(rows):
                    obj = row.get(name)
                    try:
                        v = float(obj)  # type: ignore[arg-type]
                    except (TypeError, ValueError):
                        v = mean
                    data[i, idx] = mean if np.isnan(v) else v
        return data

    def _route(self, node: RefNode, data: np.ndarray, rows: np.ndarray, out: np.ndarray):
        if node.is_real_leaf or node.split is None:
            out[rows] = node.class_value if self.is_classification else (node.predict or 0.0)
            return
        sp = node.split
        vals = data[rows, self.column_mapping[sp.column_num]]
        if sp.feature_type == CONTINUOUS:
            goes_left = vals < sp.threshold
        else:
            size = len(self.categorical_values.get(sp.column_num, []))
            idx = np.where((vals < 0) | (vals >= size), size, vals + 0.1).astype(np.int64)
            cats = set(int(c) for c in (sp.categories if sp.categories is not None else []))
            in_set = np.isin(idx, list(cats)) if cats else np.zeros(len(idx), bool)
            goes_left = in_set if sp.is_left else ~in_set
        if node.left is not None:
            self._route(node.left, data, rows[goes_left], out)
        if node.right is not None:
            self._route(node.right, data, rows[~goes_left], out)

    def predict_tree(self, tree: RefTree, data: np.ndarray) -> np.ndarray:
        out = np.zeros(data.shape[0], dtype=np.float64)
        self._route(tree.root, data, np.arange(data.shape[0]), out)
        return out

    def compute(self, data: np.ndarray, convert: str = "RAW") -> np.ndarray:
        """Regression scores, parity computeRegressionScore
        (IndependentTreeModel.java:387): GBT sums lr-weighted trees, RF does
        the weighted average; bags averaged."""
        data = np.asarray(data, dtype=np.float64)
        total = np.zeros(data.shape[0], dtype=np.float64)
        for bag in self.bags:
            per = np.stack([self.predict_tree(t, data) for t in bag], axis=1)
            wgts = np.array([t.learning_rate for t in bag])
            if self.algorithm.upper() == "GBT":
                raw = per @ wgts
                if convert == "OLD_SIGMOID":
                    raw = 1.0 / (1.0 + np.minimum(1.0e19, np.exp(-raw)))
                elif convert == "SIGMOID":
                    raw = 1.0 / (1.0 + np.minimum(1.0e19, np.exp(-20 * raw)))
                elif convert == "CUTOFF":
                    raw = np.clip(raw, 0.0, 1.0)
                total += raw
            else:
                total += (per @ wgts) / wgts.sum()
        return total / len(self.bags)


# ---------------------------------------------------------------------------
# binary stream format
# ---------------------------------------------------------------------------


def _read_category(di: JavaDataInput) -> str:
    marker = di.read_short()
    if marker < 0:
        return di._read(di.read_int()).decode("utf-8")  # noqa: SLF001
    return di.read_utf_body(marker)


def _write_category(do: JavaDataOutput, cat: str) -> None:
    if len(cat) < MAX_CATEGORICAL_VAL_LEN:
        do.write_utf(cat)
    else:
        do.write_short(-1)  # BinaryDTSerializer.UTF_BYTES_MARKER
        body = cat.encode("utf-8")
        do.write_int(len(body))
        do.write_raw(body)


def _read_split(di: JavaDataInput) -> RefSplit:
    col = di.read_int()
    ftype = di.read_byte()
    if ftype == CATEGORICAL:
        is_left = di.read_boolean()
        cats = None
        if not di.read_boolean():  # not-null marker
            words = np.frombuffer(
                bytes(di._read(di.read_int())), dtype=np.uint8  # noqa: SLF001
            )
            bits = np.unpackbits(words, bitorder="little")
            cats = np.nonzero(bits)[0].astype(np.int64)
        return RefSplit(col, ftype, is_left=is_left, categories=cats)
    return RefSplit(col, ftype, threshold=di.read_double())


def _write_split(do: JavaDataOutput, sp: RefSplit) -> None:
    do.write_int(sp.column_num)
    do.write_byte(sp.feature_type)
    if sp.feature_type == CATEGORICAL:
        do.write_boolean(sp.is_left)
        if sp.categories is None:
            do.write_boolean(True)
        else:
            do.write_boolean(False)
            max_idx = int(max(sp.categories)) if len(sp.categories) else 0
            bits = np.zeros(max_idx + 1, dtype=np.uint8)
            bits[np.asarray(sp.categories, dtype=np.int64)] = 1
            words = np.packbits(bits, bitorder="little")
            do.write_int(len(words))
            do.write_raw(words.tobytes())
    else:
        do.write_double(sp.threshold)


def _read_node(di: JavaDataInput, version: int) -> RefNode:
    node = RefNode(id=di.read_int(), gain=di.read_float())
    node.wgt_cnt = di.read_float() if version <= 2 else di.read_double()
    if di.read_boolean():
        node.split = _read_split(di)
    if di.read_boolean():  # isRealLeaf flag
        if di.read_boolean():  # predict non-null
            node.predict = di.read_double()
            node.class_value = di.read_byte()
    if di.read_boolean():
        node.left = _read_node(di, version)
    if di.read_boolean():
        node.right = _read_node(di, version)
    return node


def _write_node(do: JavaDataOutput, node: RefNode) -> None:
    do.write_int(node.id)
    do.write_float(node.gain)
    do.write_double(node.wgt_cnt)
    if node.split is None:
        do.write_boolean(False)
    else:
        do.write_boolean(True)
        _write_split(do, node.split)
    is_leaf = node.is_real_leaf
    do.write_boolean(is_leaf)
    if is_leaf:
        do.write_boolean(node.predict is not None)
        if node.predict is not None:
            do.write_double(node.predict)
            do.write_byte(node.class_value)
    for child in (node.left, node.right):
        if child is None:
            do.write_boolean(False)
        else:
            do.write_boolean(True)
            _write_node(do, child)


def _read_tree(di: JavaDataInput, version: int, with_features: bool = True) -> RefTree:
    tree_id = di.read_int()
    node_num = di.read_int()
    root = _read_node(di, version)
    lr = di.read_double()
    root_wgt = di.read_double() if root.id == ROOT_INDEX else 0.0
    features: List[int] = []
    if with_features:
        features = [di.read_int() for _ in range(di.read_int())]
    return RefTree(tree_id, node_num, root, lr, root_wgt, features)


def _write_tree(do: JavaDataOutput, tree: RefTree, with_features: bool = True) -> None:
    do.write_int(tree.tree_id)
    do.write_int(tree.node_num)
    _write_node(do, tree.root)
    do.write_double(tree.learning_rate)
    if tree.root.id == ROOT_INDEX:
        do.write_double(tree.root_wgt_cnt)
    if with_features:
        do.write_int_array(tree.features)


def read_tree_model(data: bytes) -> RefTreeModel:
    """Parse binary .gbt/.rf bytes (gzip-sniffing, version-aware)."""
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    di = JavaDataInput(io.BytesIO(data))
    version = di.read_int()
    algorithm = di.read_utf()
    loss = di.read_utf()
    is_classification = di.read_boolean()
    is_one_vs_all = di.read_boolean()
    input_node = di.read_int()
    means = {di.read_int(): di.read_double() for _ in range(di.read_int())}
    names = {di.read_int(): di.read_utf() for _ in range(di.read_int())}
    cats: Dict[int, List[str]] = {}
    for _ in range(di.read_int()):
        col = di.read_int()
        cats[col] = [_read_category(di) for _ in range(di.read_int())]
    mapping = {di.read_int(): di.read_int() for _ in range(di.read_int())}
    n_bags = di.read_int() if version >= 4 else 1
    bags = [
        [_read_tree(di, version) for _ in range(di.read_int())] for _ in range(n_bags)
    ]
    return RefTreeModel(
        algorithm, loss, is_classification, is_one_vs_all, input_node,
        means, names, cats, mapping, bags, version,
    )


def write_tree_model(model: RefTreeModel, compress: bool = True) -> bytes:
    """Serialize to the version-4 stream BinaryDTSerializer.save emits."""
    raw = io.BytesIO()
    do = JavaDataOutput(raw)
    do.write_int(TREE_FORMAT_VERSION)
    do.write_utf(model.algorithm)
    do.write_utf(model.loss)
    do.write_boolean(model.is_classification)
    do.write_boolean(model.is_one_vs_all)
    do.write_int(model.input_node)
    do.write_int(len(model.numerical_mean))
    for col, mean in model.numerical_mean.items():
        do.write_int(col)
        do.write_double(0.0 if mean is None else mean)
    do.write_int(len(model.column_names))
    for col, name in model.column_names.items():
        do.write_int(col)
        do.write_utf(name)
    do.write_int(len(model.categorical_values))
    for col, cats in model.categorical_values.items():
        do.write_int(col)
        do.write_int(len(cats))
        for cat in cats:
            _write_category(do, cat)
    do.write_int(len(model.column_mapping))
    for col, idx in model.column_mapping.items():
        do.write_int(col)
        do.write_int(idx)
    do.write_int(len(model.bags))
    for bag in model.bags:
        do.write_int(len(bag))
        for tree in bag:
            _write_tree(do, tree)
    payload = raw.getvalue()
    return gzip.compress(payload) if compress else payload


# ---------------------------------------------------------------------------
# zip spec format (shifu convert)
# ---------------------------------------------------------------------------


def read_zip_model(data: bytes) -> RefTreeModel:
    """Parse the zip spec (model.ini JSON + trees entry),
    parity IndependentTreeModelUtils.convertZipSpecToBinary (:85)."""
    zf = zipfile.ZipFile(io.BytesIO(data))
    ini = json.loads(zf.read("model.ini").decode("utf-8"))
    di = JavaDataInput(io.BytesIO(zf.read("trees")))
    bags = []
    for _ in range(di.read_int()):
        bags.append(
            [_read_tree(di, TREE_FORMAT_VERSION) for _ in range(di.read_int())]
        )
    # apply the JSON weights (trees entry stores learningRate per tree too,
    # but model.ini is authoritative after Jackson round-trip)
    for bag, wgts in zip(bags, ini.get("weights") or []):
        for tree, w in zip(bag, wgts):
            tree.learning_rate = float(w)
    return RefTreeModel(
        algorithm=ini.get("algorithm", "GBT"),
        loss=ini.get("lossStr", "squared"),
        is_classification=bool(ini.get("classification", False)),
        is_one_vs_all=bool(ini.get("oneVsAll", False)),
        input_node=int(ini.get("inputNode", 0)),
        numerical_mean={int(k): v for k, v in (ini.get("numericalMeanMapping") or {}).items()},
        column_names={int(k): v for k, v in (ini.get("numNameMapping") or {}).items()},
        categorical_values={int(k): v for k, v in (ini.get("categoricalColumnNameNames") or {}).items()},
        column_mapping={int(k): v for k, v in (ini.get("columnNumIndexMapping") or {}).items()},
        bags=bags,
    )


def write_zip_model(model: RefTreeModel) -> bytes:
    """Emit the zip spec the reference's convertBinaryToZipSpec produces."""
    ini = {
        "numNameMapping": {str(k): v for k, v in model.column_names.items()},
        "categoricalColumnNameNames": {str(k): v for k, v in model.categorical_values.items()},
        "columnCategoryIndexMapping": {
            str(k): model.category_index(k) for k in model.categorical_values
        },
        "columnNumIndexMapping": {str(k): v for k, v in model.column_mapping.items()},
        "trees": None,
        "weights": model.weights(),
        "lossStr": model.loss,
        "algorithm": model.algorithm,
        "inputNode": model.input_node,
        "numericalMeanMapping": {str(k): v for k, v in model.numerical_mean.items()},
        "gbtScoreConvertStrategy": "RAW",
        "gbdt": model.algorithm.upper() == "GBT",
        "classification": model.is_classification,
        "convertToProb": False,
        "oneVsAll": model.is_one_vs_all,
    }
    trees_buf = io.BytesIO()
    do = JavaDataOutput(trees_buf)
    do.write_int(len(model.bags))
    for bag in model.bags:
        do.write_int(len(bag))
        for tree in bag:
            _write_tree(do, tree)
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("model.ini", json.dumps(ini))
        zf.writestr("trees", trees_buf.getvalue())
    return out.getvalue()


# ---------------------------------------------------------------------------
# conversion from the port's dense tree spec (models/tree.py)
# ---------------------------------------------------------------------------


def from_dense_spec(spec) -> RefTreeModel:
    """Convert our TreeModelSpec (models/tree.py) into the reference image.

    Our trees split on bin codes; reference trees split on raw values.
    Numeric go-left masks from the trainer are contiguous code prefixes, so
    ``code < k  <=>  raw < boundaries[k]`` maps exactly. Categorical masks
    become the bitset of member category indices. GBT init_pred is folded
    into the first tree's leaves (reference GBT starts from 0).
    """
    is_gbt = spec.algorithm.upper() == "GBT"
    col_names = {j + 1: name for j, name in enumerate(spec.input_columns)}
    mapping = {j + 1: j for j in range(len(spec.input_columns))}
    means: Dict[int, float] = {}
    cats: Dict[int, List[str]] = {}
    for j, name in enumerate(spec.input_columns):
        cat = spec.categories[j] if j < len(spec.categories) else None
        if cat:
            cats[j + 1] = list(cat)
        else:
            bounds = spec.boundaries[j] or []
            finite = [b for b in bounds if np.isfinite(b)]
            means[j + 1] = float(np.mean(finite)) if finite else 0.0

    trees: List[RefTree] = []
    for t_i, dense in enumerate(spec.trees):
        node_counter = [0]

        def build(slot: int) -> Optional[RefNode]:
            if slot >= dense.n_nodes:
                return None
            f = int(dense.feature[slot])
            node_counter[0] += 1
            node = RefNode(id=slot + 1, wgt_cnt=0.0)
            if f < 0:  # leaf
                node.predict = float(dense.leaf_value[slot])
                return node
            mask = dense.left_mask[slot]
            cat = spec.categories[f] if f < len(spec.categories) else None
            if cat:
                members = np.nonzero(mask[: len(cat) + 1])[0]
                node.split = RefSplit(
                    f + 1, CATEGORICAL, is_left=True, categories=members.astype(np.int64)
                )
            else:
                bounds = spec.boundaries[f] or []
                k = int(np.argmin(mask)) if not mask.all() else len(bounds)
                thr = bounds[k] if k < len(bounds) else np.inf
                node.split = RefSplit(f + 1, CONTINUOUS, threshold=float(thr))
            node.left = build(2 * slot + 1)
            node.right = build(2 * slot + 2)
            if node.left is None and node.right is None:
                node.split = None
                node.predict = float(dense.leaf_value[slot])
            return node

        root = build(0)
        assert root is not None
        lr = 1.0 if (is_gbt and t_i == 0) else (dense.weight if not is_gbt else spec.learning_rate)
        trees.append(RefTree(t_i, node_counter[0], root, learning_rate=lr))

    if is_gbt and trees:
        # fold init_pred + per-tree weight differences into leaf values:
        # our score = init + sum(leaf_i * w_i); reference = sum(leaf'_i * lr_i)
        def scale_leaves(node: RefNode, factor: float, offset: float):
            if node.is_real_leaf and node.predict is not None:
                node.predict = node.predict * factor + offset
            for ch in (node.left, node.right):
                if ch is not None:
                    scale_leaves(ch, factor, offset)

        for t_i, (dense, tree) in enumerate(zip(spec.trees, trees)):
            factor = dense.weight / tree.learning_rate
            offset = spec.init_pred / tree.learning_rate if t_i == 0 else 0.0
            scale_leaves(tree.root, factor, offset)

    return RefTreeModel(
        algorithm=spec.algorithm.upper(),
        loss=spec.loss,
        is_classification=False,
        is_one_vs_all=False,
        input_node=len(spec.input_columns),
        numerical_mean=means,
        column_names=col_names,
        categorical_values=cats,
        column_mapping=mapping,
        bags=[trees],
    )
