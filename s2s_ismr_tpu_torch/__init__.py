"""s2s_ismr_tpu_torch — the PyTorch/CUDA port of s2s_ismr_tpu for one
NVIDIA H100.

The JAX package `s2s_ismr_tpu` stays the reference; every module here keeps
its counterpart's name (`s2s_ismr_tpu/X/y.py` -> `s2s_ismr_tpu_torch/X/y.py`)
and is held against it by the `tests/test_torch_*.py` parity tests. This
package imports `torch`, never `jax`, and nothing of `s2s_ismr_tpu`: the
numpy host layer (`timeutils`, `grid`, `field`, `data`, `io`,
`train.splits`, `profiling.StageTimer`) is the port's own copy, held
bit-equal to the JAX package's by `tests/test_torch_host.py`.

Layout (the hindcast tuning run, U-Net / tune / proba / mean predictor):
  timeutils, grid, field, io, data, profiling
             the numpy host layer: calendars, grids, labeled arrays,
             netcdf, the synthetic and IRIDL data sources, stage timers;
             torch.profiler traces
  ops        masked quantiles, rolling tercile labels, RPS/RPSS,
             REL/BSS/RES, CC/ACC, the ELR baseline (pixel-parallel IRLS)
             and the MME blend
  kernels    hand-written CUDA kernels (csrc/) with their plain versions
  models     U-Net with Keras-semantics layers, flax-variable converter
  train      losses, the training engine, the serial tuning sweep, winner
             checkpoints
  pipelines  tune configs and the tune pipeline (ELR and NN branches,
             skill mask, outputs tree), realtime, and the notebook drivers
             (accs, barplot)
  attrib, analysis
             GradCAM / saliency; CC/ACC skill maps and RPSS aggregation
  viz        figures (matplotlib, pandas and seaborn imported inside the
             drawing calls)
  run        the CLI: `python -m s2s_ismr_tpu_torch.run <config>`
"""

__version__ = "0.1.0"
