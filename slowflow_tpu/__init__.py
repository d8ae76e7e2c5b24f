"""slowflow_tpu — a JAX/XLA rebuild of the Slow Flow pipeline.

Re-implements, from scratch and in array-parallel form, the capabilities of the
CVPR 2017 "Slow Flow" reference-data pipeline (Janai et al.): adaptive frame-rate
selection (`adaptiveFR`), multi-frame occlusion-aware variational flow between
high-speed frame pairs (`slow_flow`, an extended EpicFlow energy), and dense
trajectory tracking with multi-label MRF selection (`dense_tracking`).

Layout (reference layer map in SURVEY.md §1):
  core/        image runtime: convolutions, warping, Lab, saliency, pyramids,
               penalty functions, coupled red-black SOR solver (L0, L3 kernels)
  io/          .flo codec, image/edge/match file formats (L1)
  config/      ParameterList-compatible .cfg system with experiment grids (L2)
  variational/ two-frame and multi-frame variational energies (L3)
  epic/        edge-aware geodesic sparse-to-dense interpolation (L4)
  tracking/    trajectory hypotheses, accumulation, TRW-S/BP selection (L5)
  cli/         adaptiveFR / slow_flow / dense_tracking / epicflow entry points (L6)
  parallel/    device-mesh sharding helpers (jet-parallel DP, spatial SP)
  native/      C++ host-side components (seed-graph Dijkstra k-NN)
"""

__version__ = "0.1.0"
