"""Tracking (port of ``d3d_tpu.tracking``): the detection <-> ground truth
matchers, the host Kalman and velocity trackers with their filters, and
the device-resident velocity tracker."""

from .matcher import (BaseMatcher, DistanceTypes, HungarianMatcher,
                      NearestNeighborMatcher, ScoreMatcher)
from .filter import (Box_KF, Pose_3DOF_UKF_CV, Pose_3DOF_UKF_CTRA,
                     Pose_3DOF_UKF_CTRV, motion_CTRA, motion_CTRV, motion_CV,
                     wrap_angle)
from .tracker import VanillaTracker
from .center_tracker import CenterTracker
from .device_tracker import (DeviceCenterTracker, make_tracking_step,
                             tracker_init, tracker_report,
                             tracker_scan_sequence, tracker_update)

__all__ = [
    "BaseMatcher", "DistanceTypes", "HungarianMatcher",
    "NearestNeighborMatcher", "ScoreMatcher",
    "Box_KF", "Pose_3DOF_UKF_CV", "Pose_3DOF_UKF_CTRA", "Pose_3DOF_UKF_CTRV",
    "motion_CV", "motion_CTRV", "motion_CTRA", "wrap_angle",
    "VanillaTracker", "CenterTracker",
    "DeviceCenterTracker", "make_tracking_step",
    "tracker_init", "tracker_report", "tracker_scan_sequence",
    "tracker_update",
]
