"""`shifu encode` — encode a dataset against the trained model.

Counterpart of `shifu_tpu/processor/encode.py` (ModelDataEncodeProcessor.java
+ udf/EncodeDataUDF.java): tree models emit the per-tree leaf index
(tree-path encoding); other models fall back to woe encoding of every
candidate column. Output: tmp/encode/EncodedData (tag|f0|f1|...), the
JAX package's bytes.

The tree path walks each tree on the device (`models.tree.leaf_nodes`),
following a leaf-wise tree's explicit child pointers. The JAX package
always steps to 2i+1/2i+2, so on a leaf-wise forest its leaf ids are
wrong (ROADMAP C.8); on a level-wise forest both agree. The woe path runs
the norm plan's value and table norms on the device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from shifu_tpu_torch.data.purify import combined_mask
from shifu_tpu_torch.data.reader import make_tags, read_columnar, read_header
from shifu_tpu_torch.processor.basic import BasicProcessor
from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike

log = get_logger(__name__)


class EncodeProcessor(BasicProcessor):
    step = "encode"

    def __init__(self, root: str = ".", dataset: str = None,
                 device: DeviceLike = None):
        super().__init__(root, device=device)
        self.dataset = dataset  # eval set name; None = training data

    def _load(self):
        mc = self.model_config
        ds = mc.data_set
        if self.dataset:
            ec = mc.get_eval(self.dataset)
            if ec is None:
                raise ShifuError(ErrorCode.INVALID_MODEL_CONFIG,
                                 f"eval set {self.dataset} not found")
            src = ec.data_set
            data_path = src.data_path or ds.data_path
            header_path = src.header_path or ds.header_path
            delim = src.data_delimiter or ds.data_delimiter
        else:
            data_path, header_path, delim = (ds.data_path, ds.header_path,
                                             ds.data_delimiter)
        names = (read_header(self.resolve(header_path), ds.header_delimiter)
                 if header_path
                 else [c.column_name for c in self.column_configs])
        data = read_columnar(self.resolve(data_path), names, delimiter=delim,
                             missing_values=tuple(ds.missing_or_invalid_values))
        mask = combined_mask(ds.filter_expressions, data.raw, data.n_rows)
        data = data.select_rows(mask)
        tags = make_tags(data.column(ds.target_column_name), ds.pos_tags,
                         ds.neg_tags)
        return data, tags

    def run_step(self) -> None:
        self.setup()
        from shifu_tpu_torch.eval.scorer import find_model_paths, load_model

        data, tags = self._load()
        out_dir = self.paths.ensure(self.paths.tmp_dir("encode"))
        out = os.path.join(out_dir, "EncodedData")
        paths = find_model_paths(self.paths.models_dir())
        tree_specs = [load_model(p) for p in paths
                      if p.endswith((".gbt", ".rf"))]

        if tree_specs:
            feats, names = self._tree_path_encode(tree_specs[0], data)
        else:
            feats, names = self._woe_encode(data)

        with open(out, "w") as fh:
            fh.write("|".join(["tag"] + names) + "\n")
            for i in range(data.n_rows):
                fh.write("|".join([str(int(tags[i]))] +
                                  [f"{v:g}" for v in feats[i]]) + "\n")
        log.info("encoded %d rows x %d features -> %s",
                 data.n_rows, len(names), out)

    def _tree_path_encode(self, spec, data):
        """Per record per tree: index of the leaf reached
        (EncodeDataUDF tree-path encoding)."""
        from shifu_tpu_torch.models.tree import leaf_nodes

        codes = torch.as_tensor(spec.independent(self.device)
                                .codes_from_raw(data), device=self.device)
        feats = leaf_nodes(spec.trees, codes).cpu().numpy().astype(np.int32)
        return feats, [f"tree_{k}" for k in range(len(spec.trees))]

    def _woe_encode(self, data):
        from shifu_tpu_torch.config.model_config import NormType
        from shifu_tpu_torch.norm.normalizer import (apply_norm_plan,
                                                     build_norm_plan)

        mc = self.model_config
        orig = mc.normalize.norm_type
        mc.normalize.norm_type = NormType.WOE
        try:
            plan = build_norm_plan(mc, self.column_configs)
            feats = apply_norm_plan(plan, data, device=self.device)
            return feats, plan.out_names
        finally:
            mc.normalize.norm_type = orig
