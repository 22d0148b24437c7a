"""shifu-tpu ported to PyTorch and CUDA for NVIDIA Hopper (H100).

The JAX package `shifu_tpu` stays the reference; this package is its
counterpart, slice by slice. It imports torch and numpy, never jax and
never `shifu_tpu`. Entry points run on the card (`device=None` means
cuda) unless the caller asks for the CPU.

Slice 1: level-wise GBT/RF training (`train.tree_trainer.train_trees`)
through the hand-written histogram -> split-scan CUDA kernel
(`ops.hist_kernel`, source `csrc/hist_level.cu`), the CleanedData bin-code
format (`norm.dataset`), and the `.gbt`/`.rf` tree model (`models.tree`).

Slice 2: the `shifu train` step for trees (`processor.train`, CLI
`python -m shifu_tpu_torch train`) over a model-set directory, with the
configs, paths and helpers it reads (`config`, `fs.pathfinder`,
`utils.environment`), and NATIVE multi-class RF through the kernel's
multi-class mode.

Slice 6: `shifu init` and in-RAM `shifu stats` from raw text
(`processor.init`, `processor.stats`, CLI `init` and `stats`), over an
ingest of its own that needs no pandas (`data`: the reader and
pandas' numeric grammar; `stats`: binning, the autotype sketches with
pandas' hash, metrics, PSI, correlation), with the bin aggregation
(`ops.binagg`) and the correlation on the device.

Slice 7: `shifu norm` and `shifu varsel` (`processor.norm`,
`processor.varsel`, CLI `norm` and `varsel`): the NormType plans and the
value and table norms on the device (`norm.normalizer`), NormalizedData
and CleanedData (`norm.dataset`), the KS/IV/MIX/PARETO filters, the
auto-filter and tree feature importance (`varsel`). Raw text -> init ->
stats -> norm -> varsel -> norm -> train runs in this package alone.

Slice 8: `shifu train` for NN, LR and SVM in memory (`models.nn`, the
`.nn` model file; `train.updaters`; `train.nn_trainer`, one epoch loop
over a member axis for bagging, ONEVSALL, grid trials and k-fold;
`train.grid_search`), and varsel's SE/ST sensitivity wrapper
(`varsel.selector.sensitivity_scores`).

Slice 9: `shifu posttrain` and in-memory `shifu eval` (`processor.posttrain`,
`processor.evaluate`, `eval`), so the whole lifecycle runs in this package.

Slice 10: `shifu serve`, single-tenant (`serve`, CLI `serve`): the model
registry's fused raw -> score program of torch ops, the micro-batcher,
the admission queue, health and circuit breaker, the replica fleet and
router, the columnar binary wire format and the HTTP front end.

Then the leaf-wise grower (`train.tree_trainer.build_tree_leafwise`,
max_leaves > 0) and the host-batched one (`build_tree`, 2**max_depth past
the stats-memory node batch), both on the histogram-only and scan-only
CUDA entries; the lifecycle's ends and small host steps: `new`
(`processor.create`), `export` (`processor.export` over its own PMML
writer `export.pmml`), `save` / `switch` / `show` (`processor.manage`),
`test` (`processor.testdata`), `analysis`, `encode` (the tree path
follows leaf-wise trees' child pointers) and `combo`, and `version`.
"""

__version__ = "0.1.0"
