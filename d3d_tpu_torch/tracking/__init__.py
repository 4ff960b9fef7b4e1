"""Tracking (port of ``d3d_tpu.tracking``): so far the detection <-> ground
truth matchers the evaluators use."""

from .matcher import (BaseMatcher, DistanceTypes, HungarianMatcher,
                      NearestNeighborMatcher, ScoreMatcher)

__all__ = ["BaseMatcher", "DistanceTypes", "HungarianMatcher",
           "NearestNeighborMatcher", "ScoreMatcher"]
