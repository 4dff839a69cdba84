"""Kernel wrappers of the port; the kernels are built on first use."""

# each kernel's name (as chip_smoke.py's JSON line gives it) and the
# module and counter of ops/ that its wrapper adds one to at each launch
COUNTERS = {
    "meta_block_fwd": ("meta_block", "launches"),
    "meta_block_fwd_stash": ("meta_block", "stash_launches"),
    "meta_block_fwd_stash_light": ("meta_block", "stash_light_launches"),
    "meta_block_fwd_scores": ("meta_block", "scores_launches"),
    "meta_block_bwd": ("meta_block", "bwd_launches"),
    "meta_block_bwd_stash": ("meta_block", "stash_bwd_launches"),
    "meta_block_bwd_stash_light": ("meta_block", "stash_light_bwd_launches"),
    "tiled_meta_fwd": ("tiled_meta", "launches"),
    "tiled_meta_fwd_stash": ("tiled_meta", "stash_launches"),
    "tiled_meta_bwd": ("tiled_meta", "bwd_launches"),
    "tiled_meta_bwd_stash": ("tiled_meta", "stash_bwd_launches"),
    "gate_block_fwd": ("gate_block", "launches"),
    "gate_block_bwd": ("gate_block", "bwd_launches"),
    "gather_rows": ("gather", "launches"),
    "scatter_rows_set": ("scatter", "launches"),
    "eqgemm_positions": ("eqgemm", "launches"),
    "lazy_adam_rows": ("lazy_tail", "launches"),
}


def launch_counts() -> dict[str, int]:
    """Every kernel's launch counter, by kernel name.  A counter moves
    where a wrapper launches its kernel; the replay of a CUDA graph that
    captured the launch moves none (``serving.Predictor`` counts its
    replays)."""
    import importlib
    return {name: getattr(importlib.import_module(f"{__name__}.{mod}"), attr)
            for name, (mod, attr) in COUNTERS.items()}
