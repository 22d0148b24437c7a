"""`shifu test` — dry-run data/filter validation on N sample records.

Parity: core/processor/ShifuTestProcessor.java:33 — parse the first N
records, apply the filter expression, report pass/fail counts and tag
coverage so config errors surface before long jobs.

The port's own copy of `shifu_tpu/processor/testdata.py`, over the
port's reader. It touches no device.
"""

from __future__ import annotations

from shifu_tpu_torch.data.purify import combined_mask
from shifu_tpu_torch.data.reader import make_tags, read_columnar, read_header
from shifu_tpu_torch.processor.basic import BasicProcessor
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)


class TestDataProcessor(BasicProcessor):
    step = "test"
    host_only = True

    def __init__(self, root: str = ".", n: int = 100):
        super().__init__(root)
        self.n = n

    def run_step(self) -> None:
        self.setup(need_columns=False)
        mc = self.model_config
        ds = mc.data_set
        names = read_header(self.resolve(ds.header_path), ds.header_delimiter)
        data = read_columnar(
            self.resolve(ds.data_path), names, delimiter=ds.data_delimiter,
            missing_values=tuple(ds.missing_or_invalid_values),
            max_rows=self.n,
        )
        log.info("read %d records, %d columns.", data.n_rows, len(names))
        if ds.target_column_name not in names:
            log.error("target column %s NOT in header!", ds.target_column_name)
            return
        mask = combined_mask(ds.filter_expressions, data.raw, data.n_rows)
        log.info("filter `%s`: %d of %d records pass.",
                 ds.filter_expressions or "(none)", int(mask.sum()), data.n_rows)
        tags = make_tags(data.column(ds.target_column_name)[mask],
                         ds.pos_tags, ds.neg_tags)
        n_pos = int((tags == 1).sum())
        n_neg = int((tags == 0).sum())
        n_bad = int((tags == -1).sum())
        log.info("tags: %d positive, %d negative, %d invalid.",
                 n_pos, n_neg, n_bad)
        if n_bad:
            log.warning("%d records have tags outside posTags/negTags!", n_bad)
        if n_pos == 0:
            log.warning("no positive records in the sample — check posTags.")
