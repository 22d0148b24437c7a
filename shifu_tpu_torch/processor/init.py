"""`shifu init` — build the initial ColumnConfig list from the data header
(counterpart of `shifu_tpu/processor/init.py`).

Parity: core/processor/InitModelProcessor.java:89 —
  1. parse the header (or first data row when headerPath is unset);
  2. assign column roles from the role files (meta/categorical/forceselect/
     forceremove) and targetColumnName/weightColumnName;
  3. auto-type detection: distinct counts + numeric-parse ratio decide
     numeric vs categorical (reference autotype MR job,
     core/autotype/AutoTypeDistinctCountMapper.java:45), folded chunk by
     chunk into one sketch set (`stats/sketch.py`).
The step does no device work, but like every entry point of the port it
takes `device=None` to mean the card and raises without one.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import List, Optional, Set

from shifu_tpu_torch.config import ColumnConfig, ColumnFlag, ColumnType
from shifu_tpu_torch.data.pipeline import HostPlan
from shifu_tpu_torch.data.reader import read_header, strip_namespace
from shifu_tpu_torch.data.stream import iter_columnar_chunks
from shifu_tpu_torch.fs.listing import expand_paths
from shifu_tpu_torch.parallel import hostsync
from shifu_tpu_torch.processor.basic import BasicProcessor
from shifu_tpu_torch.resilience.checkpoint import config_sha
from shifu_tpu_torch.stats.sketch import AutoTypeSketch
from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike

log = get_logger(__name__)

# cap rows scanned for auto-type detection; exact beyond this scale is wasted IO
AUTOTYPE_MAX_ROWS = 1_000_000


def _read_names_file(path: Optional[str], root: str) -> Set[str]:
    if not path:
        return set()
    full = path if os.path.isabs(path) else os.path.join(root, path)
    if not os.path.isfile(full):
        return set()
    names = set()
    with open(full) as fh:
        for line in fh:
            line = line.strip()
            if line and not line.startswith("#"):
                names.add(strip_namespace(line))
    return names


class InitProcessor(BasicProcessor):
    step = "init"

    def __init__(self, root: str = ".", device: DeviceLike = None,
                 host_plan: Optional[HostPlan] = None):
        super().__init__(root, device=device)
        # an explicit HostPlan (in-process multi-host runs, tests);
        # None reads the lifecycle knobs
        self.host_plan = host_plan

    def run_step(self) -> None:
        self.setup(need_columns=False)
        mc = self.model_config
        assert mc is not None
        ds = mc.data_set

        if ds.header_path:
            names = read_header(self.resolve(ds.header_path), ds.header_delimiter)
        else:
            # fall back to first data row as header (reference behavior when
            # headerPath empty: first line treated as header); data_path may
            # be a directory of part files
            first = expand_paths(self.resolve(ds.data_path))[0]
            names = read_header(first, ds.data_delimiter)

        target = strip_namespace(ds.target_column_name)
        if target not in names:
            raise ShifuError(ErrorCode.TARGET_NOT_FOUND, target)

        meta_cols = _read_names_file(ds.meta_column_name_file, self.root)
        cate_cols = _read_names_file(ds.categorical_column_name_file, self.root)
        force_select = _read_names_file(
            mc.var_select.force_select_column_name_file, self.root
        )
        force_remove = _read_names_file(
            mc.var_select.force_remove_column_name_file, self.root
        )
        weight_col = strip_namespace(ds.weight_column_name or "")

        columns: List[ColumnConfig] = []
        for i, name in enumerate(names):
            cc = ColumnConfig(column_num=i, column_name=name)
            if name == target:
                cc.column_flag = ColumnFlag.TARGET
            elif name == weight_col and weight_col:
                cc.column_flag = ColumnFlag.WEIGHT
            elif name in meta_cols:
                cc.column_flag = ColumnFlag.META
            elif name in force_remove:
                cc.column_flag = ColumnFlag.FORCE_REMOVE
            elif name in force_select:
                cc.column_flag = ColumnFlag.FORCE_SELECT
                cc.final_select = True
            if name in cate_cols:
                cc.column_type = ColumnType.C
            columns.append(cc)

        hp = self.host_plan if self.host_plan is not None else HostPlan()
        self._auto_type(columns, names, cate_cols, hp)
        self.column_configs = columns
        if hp.active and not hp.is_merge_host:
            # every host merged the same sketches; one writes the files
            log.info("autotype computed on host %d/%d; the merge host "
                     "writes ColumnConfig.json", hp.host_index, hp.n_hosts)
            return
        self.save_column_configs()
        log.info(
            "ColumnConfig.json initialized: %d columns (%d categorical, target=%s).",
            len(columns),
            sum(1 for c in columns if c.is_categorical()),
            target,
        )

    def _auto_type(
        self, columns: List[ColumnConfig], names: List[str],
        user_cate: Set[str], hp: HostPlan,
    ) -> None:
        mc = self.model_config
        assert mc is not None
        ds = mc.data_set
        candidates = [
            cc for cc in columns
            if not (cc.is_target() or cc.is_meta() or cc.is_weight())
        ]
        missing = tuple(ds.missing_or_invalid_values)
        sketches = {cc.column_name: AutoTypeSketch(missing)
                    for cc in candidates}
        if hp.active:
            # a part an earlier run left must not satisfy a peer's barrier
            hostsync.clear_part(self.root, "init-autotype", hp)
        # only the candidate columns are kept at all: target/meta/weight
        # (fat padding fields included) never leave the tokenizer; a host
        # folds only the chunks it owns
        for ci, chunk in enumerate(iter_columnar_chunks(
                self.resolve(ds.data_path),
                names,
                delimiter=ds.data_delimiter,
                missing_values=missing,
                max_rows=AUTOTYPE_MAX_ROWS,
                columns=[cc.column_name for cc in candidates])):
            if not hp.owns(ci):
                continue
            for cc in candidates:
                sketches[cc.column_name].update(chunk.column(cc.column_name))
            hp.record(chunk.n_rows, "init.autotype")
        if hp.active:
            # all-gather the hosts' sketch sets; every host merges them in
            # host order, so the fleet agrees on every count
            sha = config_sha({
                "columns": [cc.column_name for cc in candidates],
                "missing": list(missing),
                "maxRows": AUTOTYPE_MAX_ROWS,
            })
            hostsync.publish_part(self.root, "init-autotype", hp, sha,
                                  blob=pickle.dumps(sketches))
            parts = hostsync.await_parts(self.root, "init-autotype", hp,
                                         sha)
            log.info("autotype: %s", hp.describe())
            sketches = pickle.loads(parts[0][2])
            for _arrays, _meta, blob in parts[1:]:
                other = pickle.loads(blob)
                for name, sk in sketches.items():
                    sk.merge(other[name])

        threshold = ds.auto_type_threshold
        count_info = {}
        for cc in columns:
            if cc.is_target() or cc.is_meta() or cc.is_weight():
                continue
            sk = sketches[cc.column_name]
            distinct = sk.distinct_count()
            cc.column_stats.distinct_count = int(distinct)
            num_ratio = sk.numeric_ratio()
            count_info[cc.column_name] = {
                "distinctCount": int(distinct),
                "numericRatio": round(float(num_ratio), 6),
            }
            if cc.column_name in user_cate:
                continue  # user decision wins
            if cc.column_type is None and ds.autoType and threshold > 0:
                if num_ratio < threshold / 100.0:
                    cc.column_type = ColumnType.C
                    log.info(
                        "Column %s auto-typed categorical (numeric ratio %.3f).",
                        cc.column_name,
                        num_ratio,
                    )
                else:
                    cc.column_type = ColumnType.N
            elif cc.column_type is None:
                cc.column_type = ColumnType.N
        if hp.active and not hp.is_merge_host:
            return  # the merge host writes the autotype artifact
        out = self.paths.autotype_path()
        self.paths.ensure(os.path.dirname(out))
        with open(out, "w") as fh:
            json.dump(count_info, fh, indent=1)
