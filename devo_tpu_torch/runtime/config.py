"""Runtime configuration.

The port's own copy of devo_tpu/runtime/config.py (the JAX one cannot be
imported without jax): the reference knobs of the yacs node
(upstream DEVO's devo/config.py) plus the static sizes the engine keeps
(ring depth, edge bound, precision switches).

Three of the JAX package's correlation knobs are kept, with its names and
defaults, because they choose what the correlation computes or which of the
port's kernels computes it: CORR_RING_I8 (int8 feature rings with one
dequantisation scale per ring slot), CORR_KERNEL ("mono", "pair", "pair2":
both levels in one launch, by three different kernels; "split": one launch
per level) and CORR_L4_RESIDENT (level 4 read from a ring slot held in
shared memory). The rest stay out: CORR_IMPL,
CORR_WIN_L1, VOXEL_WIRE and the encoder-layout switches choose TPU
schedules, window budgets and transports, not functions.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class VOConfig:
    # reference knobs (devo/config.py:6-32; yaml values in comments)
    BUFFER_SIZE: int = 4096
    HT: int = 480                        # image height
    WD: int = 640                        # image width
    GRADIENT_BIAS: bool = False
    PATCH_SELECTOR: str = "scorer"
    SCORER_EVAL_MODE: str = "multi"
    SCORER_EVAL_USE_GRID: bool = True
    NORM: str = "std"
    EVS: bool = True                     # event voxels; False = frame input
    BINS: int = 5                        # input channels (3 for frames)
    PATCHES_PER_FRAME: int = 96          # default_evs.yaml: 96 (config.py: 80)
    REMOVAL_WINDOW: int = 22             # yaml: 22
    OPTIMIZATION_WINDOW: int = 10        # yaml: 10
    PATCH_LIFETIME: int = 13             # yaml: 13
    KEYFRAME_INDEX: int = 4
    KEYFRAME_THRESH: float = 15.0
    MOTION_MODEL: str = "DAMPED_LINEAR"
    MOTION_DAMPING: float = 0.5
    MOTION_PROBE_THRESH: float = 2.0     # devo.py:532 (2.0 at scale 1)
    MIXED_PRECISION: bool = True         # bf16 autocast for the networks and
                                         # bf16 patch features (and rings,
                                         # unless CORR_RING_I8)

    # network shape
    PATCH_SIZE: int = 3
    DIM_INET: int = 384
    DIM_FNET: int = 128
    DIM: int = 32
    CORR_RADIUS: int = 3
    CORR_LEVELS: tuple = (1, 4)

    # static sizes
    MEM: int = 32                        # feature ring buffer (devo.py:69)
    EDGE_CAP: int = 0                    # hard bound on live edges; 0 ->
                                         #   the worst case derived below.
                                         #   Appends past it drop the tail.
    ENET_BF16: bool = True               # store the recurrent per-edge hidden
                                         #   state in bf16 (the update
                                         #   operator LayerNorms it first)

    # what the correlation computes, and with which kernel
    CORR_KERNEL: str = "mono"            # "mono": both pyramid levels in one
                                         #   launch, a warp per tap
                                         #   (csrc/corr.cu);
                                         # "split": one launch per level
                                         #   (csrc/corr_level.cu);
                                         # "pair": both levels in one launch,
                                         #   a block per edge, each level's
                                         #   window on its own copy group
                                         #   (csrc/corr_pair.cu);
                                         # "pair2": the same by persistent
                                         #   blocks with the next edge's
                                         #   windows in flight
                                         #   (csrc/corr_pair2.cu)
    CORR_L4_RESIDENT: str = "off"        # level 4 from a ring slot held whole
                                         #   in a block's shared memory
                                         #   (csrc/corr_level_resident.cu):
                                         #   "on", "off", or "auto" = on iff a
                                         #   level-4 frame fits (devo_tpu's
                                         #   rule: "fits", not "is faster";
                                         #   on an H100 corr_level reads level
                                         #   4 faster, so "off" is the quicker
                                         #   choice there, see PERF.md). Needs
                                         #   int8 rings and CORR_KERNEL="split"
    CORR_RING_I8: bool = True            # store the correlation feature rings
                                         #   as per-frame-scaled int8: the
                                         #   correlation is linear in the frame
                                         #   features, so one per-slot scale on
                                         #   the output dequantises it. False =
                                         #   rings in the net dtype

    def __post_init__(self):
        if self.EDGE_CAP == 0:
            # worst-case live edges: patches from the last REMOVAL_WINDOW+2
            # frames, each with at most 2*PATCH_LIFETIME-1 edges, plus one
            # freshly appended block before compaction.
            per_patch = 2 * self.PATCH_LIFETIME - 1
            bound = self.PATCHES_PER_FRAME * (self.REMOVAL_WINDOW + 2) * per_patch
            bound += self.PATCHES_PER_FRAME * per_patch
            object.__setattr__(self, "EDGE_CAP", _round_up(bound, 1024))

    # derived statics
    @property
    def M(self) -> int:
        return self.PATCHES_PER_FRAME

    @property
    def P(self) -> int:
        return self.PATCH_SIZE

    @property
    def ba_window(self) -> int:
        return max(self.OPTIMIZATION_WINDOW, 8)

    @property
    def frame_span(self) -> int:
        """Frame range that live edges can touch, for dense segment ids."""
        return self.REMOVAL_WINDOW + 4

    @property
    def patch_slots(self) -> int:
        return self.frame_span * self.M

    def replace(self, **kw) -> "VOConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_yaml(cls, path: str, base: "VOConfig" = None) -> "VOConfig":
        """Load a reference-format yaml override file (`config/eval_*.yaml`).
        Unknown keys are rejected so typos don't silently fall back to
        defaults."""
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - fields
        if unknown:
            raise ValueError(f"{path}: unknown config keys {sorted(unknown)}")
        base = base if base is not None else cls()
        if not raw:
            return base
        # re-derive EDGE_CAP only when a sizing knob changes: an explicitly
        # pinned base EDGE_CAP survives unrelated overrides
        sizing = {"PATCHES_PER_FRAME", "REMOVAL_WINDOW", "PATCH_LIFETIME"}
        if sizing & set(raw):
            raw = {"EDGE_CAP": 0, **raw}
        return dataclasses.replace(base, **raw)


# per-benchmark overrides mirroring upstream DEVO's config/eval_*.yaml
DEFAULT_EVS = VOConfig()
# the eval configurations keep unquantised rings: accuracy claims must not
# ride on the int8 rounding of the features
_EVAL_BASE = DEFAULT_EVS.replace(CORR_RING_I8=False)
EVAL_CONFIGS = {
    "default": _EVAL_BASE,                                   # KEYFRAME_THRESH 15
    "eds": _EVAL_BASE.replace(KEYFRAME_THRESH=25.0),
    "fpv": _EVAL_BASE.replace(KEYFRAME_THRESH=5.0),
    "rpg": _EVAL_BASE.replace(KEYFRAME_THRESH=5.0),
    "hku": _EVAL_BASE,
    "mvsec": _EVAL_BASE.replace(KEYFRAME_THRESH=5.0),
    "vector": _EVAL_BASE,
    "tumvie": _EVAL_BASE,
    "tartanair": _EVAL_BASE,
}
