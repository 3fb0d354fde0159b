"""Evaluation suite: KITTI eigen/benchmark depth metrics, SYNS edge +
point-cloud metrics (plain-torch chamfer search in place of the reference's
external CUDA extension), KITTI odometry ATE."""
