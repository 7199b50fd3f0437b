from .scoring import (
    Log2MedianScoring,
    RankScoring,
    ScoringModel,
    ThresholdScoring,
    WeightScoring,
)

__all__ = [
    "RankScoring",
    "ScoringModel",
    "ThresholdScoring",
    "Log2MedianScoring",
    "WeightScoring",
]
