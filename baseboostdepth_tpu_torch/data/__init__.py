"""Data: device-side augmentation."""
