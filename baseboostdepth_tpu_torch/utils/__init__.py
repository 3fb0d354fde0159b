"""Small shared utilities, the counterpart of `baseboostdepth_tpu/utils`."""

from baseboostdepth_tpu_torch.utils.misc import (  # noqa: F401
    colormap,
    normalize_image,
    readlines,
    resolve_splits_dir,
    sec_to_hm_str,
)
