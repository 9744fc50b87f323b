from yag_slam_tpu.matching.matcher import (
    CorrelativeScanMatcher,
    Scan2DMatcher,
    ScanMatcherResult,
)
from yag_slam_tpu.matching.refmatcher import RefBaselineScanMatcher

# Drop-in aliases for the reference's two matcher classes
# (/root/reference/yag_slam/scan_matching.py:32,45): both map onto the one
# implementation here.
Scan2DMatcherCpp = CorrelativeScanMatcher
Scan2DMatcherPy = CorrelativeScanMatcher

__all__ = [
    "CorrelativeScanMatcher",
    "RefBaselineScanMatcher",
    "Scan2DMatcher",
    "Scan2DMatcherCpp",
    "Scan2DMatcherPy",
    "ScanMatcherResult",
]
