"""Data: KITTI indexing, the curriculum, the host loader, device-side
augmentation."""
