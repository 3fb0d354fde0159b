"""Native (C++) host-runtime components: batch JPEG decode + resize."""

from baseboostdepth_tpu_torch.native.loader import (  # noqa: F401
    decode_resize_batch,
    native_available,
)
