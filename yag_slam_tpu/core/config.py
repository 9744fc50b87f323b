"""Matcher configuration.

The reference layers Python dicts onto a C++ config object
(`default_config` / `default_config_loop` / `make_config`,
/root/reference/yag_slam/helpers.py:339-376).  Here the config is a plain
frozen dataclass with the same 11 keys and defaults, so it serializes into
checkpoints exactly like the reference's (`serde` registers the config type
with its public fields, /root/reference/yag_slam/serde.py:88-92).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ScanMatcherConfig:
    """Same key set and defaults as the reference's `default_config`
    (/root/reference/yag_slam/helpers.py:339-351).

    DELIBERATE DECISION on the three penalty keys:
    `angle_variance_penalty`, `distance_variance_penalty` and
    `minimum_angle_penalty` are carried for config/serde/checkpoint parity
    but, by DEFAULT, NOT consumed by the scoring kernels.  The reference's
    *executable Python spec* hardcodes dist_var=0.5, ang_var=1.0 and
    comments out the minimum-penalty clamps
    (/root/reference/yag_slam/helpers.py:181-184, 204, 208) — note its own
    config default ang=0.3 differs from the 1.0 it actually uses.
    OpenKarto's C++ matcher does consume them (and clamps at the
    minimums); following it by default would silently diverge from the
    Python spec that every golden test in tests/test_matching.py pins.

    `use_karto_penalties=True` opts into the
    C++-matcher semantics instead: penalties computed as
    max(1 - 0.2*offset^2/variance, minimum) with the offsets measured
    from the SEARCH CENTER and the config's variance keys consumed
    directly (no grid-resolution division) — OpenKarto Mapper.cpp
    ScanMatcher::CorrelateScan, surfaced through the reference's config
    keys at /root/reference/yag_slam/helpers.py:339-351.
    `minimum_distance_penalty` (Karto default 0.5) completes that key
    set; it and the switch are this engine's extensions, written into
    checkpoints only when non-default (slam/serde.py keeps the wire
    format byte-identical to the reference otherwise)."""

    angle_variance_penalty: float = 0.3
    distance_variance_penalty: float = 0.5
    coarse_search_angle_offset: float = 0.349
    coarse_angle_resolution: float = 0.0349
    fine_search_angle_resolution: float = 0.00349
    use_response_expansion: bool = True
    range_threshold: float = 20.0
    minimum_angle_penalty: float = 0.9
    search_size: float = 0.5
    resolution: float = 0.01
    smear_deviation: float = 0.05
    # -- extensions beyond the reference's 11 keys (see docstring) --
    use_karto_penalties: bool = False
    minimum_distance_penalty: float = 0.5

    def karto_penalty_tuple(self):
        """(dist_var, ang_var, min_dist, min_ang) for the scoring kernels
        when `use_karto_penalties`, else None."""
        if not self.use_karto_penalties:
            return None
        return (
            float(self.distance_variance_penalty),
            float(self.angle_variance_penalty),
            float(self.minimum_distance_penalty),
            float(self.minimum_angle_penalty),
        )

    def replace(self, **kw) -> "ScanMatcherConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def validate(self) -> "ScanMatcherConfig":
        lo, hi = 0.5 * self.resolution, 10.0 * self.resolution
        if not (lo <= self.smear_deviation <= hi):
            # same constraint as /root/reference/yag_slam/helpers.py:370
            raise ValueError(
                f"Smear deviation must be between {lo} and {hi}, "
                f"got {self.smear_deviation}"
            )
        return self


# The reference's 11 config keys (/root/reference/yag_slam/helpers.py:
# 339-351) in its serde order (dir()-alphabetical) — the checkpoint wire
# format.  Extension fields are written only when non-default.
REFERENCE_CONFIG_KEYS = tuple(sorted([
    "angle_variance_penalty", "distance_variance_penalty",
    "coarse_search_angle_offset", "coarse_angle_resolution",
    "fine_search_angle_resolution", "use_response_expansion",
    "range_threshold", "minimum_angle_penalty", "search_size",
    "resolution", "smear_deviation",
]))

# Same values as /root/reference/yag_slam/helpers.py:339-351
default_config = ScanMatcherConfig().to_dict()

# Same overrides as /root/reference/yag_slam/helpers.py:353-361
default_config_loop = dict(
    default_config,
    coarse_search_angle_offset=0.349,
    coarse_angle_resolution=0.0349,
    resolution=0.05,
    search_size=4.0,
    smear_deviation=0.05,
)


def make_config(d: dict | None = None, loop: bool = False) -> ScanMatcherConfig:
    """Overlay a user dict on the defaults and validate, mirroring
    /root/reference/yag_slam/helpers.py:364-376."""
    params = dict(default_config_loop if loop else default_config)
    if d:
        params.update({k: v for k, v in d.items() if k != "___name"})
    return ScanMatcherConfig(**params).validate()


def print_config(config) -> None:
    for field in dataclasses.fields(config):
        print(f"{field.name}: {getattr(config, field.name)}")
