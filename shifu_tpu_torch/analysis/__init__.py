"""shifu_tpu_torch.analysis: the runtime sanitizer's divergence mode
(counterpart of `shifu_tpu/analysis/`)."""
