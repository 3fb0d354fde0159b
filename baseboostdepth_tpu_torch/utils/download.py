"""Pretrained-model fetcher (reference utils.py:46-109
download_model_if_doesnt_exist), a copy of
`baseboostdepth_tpu/utils/download.py` for the port.

Downloads a published checkpoint zip, verifies its md5, and unpacks it to a
weights folder ready for the port's importers
(models/torch_import.IMPORTERS); fetches torchvision's ImageNet ResNets for
`--model.weights_init pretrained`. The
Monodepth2 table below carries the same public URLs/checksums the reference
ships; BaseBoostDepth's own released checkpoints live on Google Drive
(reference README.md:51-53), which has no stable direct URL -- fetch those
manually (or via gdown) and point --weights at the folder.
"""

from __future__ import annotations

import hashlib
import os
import zipfile

# (url, md5) per model zip, verbatim from the reference's public table
# (utils.py:50-79) -- these are Monodepth2's released weights, the ImageNet/
# pretrained starting points for the "(pre)" configs.
MODEL_URLS = {
    "mono_640x192": (
        "https://storage.googleapis.com/niantic-lon-static/research/monodepth2/mono_640x192.zip",
        "a964b8356e08a02d009609d9e3928f7c"),
    "stereo_640x192": (
        "https://storage.googleapis.com/niantic-lon-static/research/monodepth2/stereo_640x192.zip",
        "3dfb76bcff0786e4ec07ac00f658dd07"),
    "mono+stereo_640x192": (
        "https://storage.googleapis.com/niantic-lon-static/research/monodepth2/mono%2Bstereo_640x192.zip",
        "c024d69012485ed05d7eaa9617a96b81"),
    "mono_no_pt_640x192": (
        "https://storage.googleapis.com/niantic-lon-static/research/monodepth2/mono_no_pt_640x192.zip",
        "9c2f071e35027c895a4728358ffc913a"),
    "stereo_no_pt_640x192": (
        "https://storage.googleapis.com/niantic-lon-static/research/monodepth2/stereo_no_pt_640x192.zip",
        "41ec2de112905f85541ac33a854742d1"),
    "mono+stereo_no_pt_640x192": (
        "https://storage.googleapis.com/niantic-lon-static/research/monodepth2/mono%2Bstereo_no_pt_640x192.zip",
        "46c3b824f541d143a45c37df65fbab0a"),
    "mono_1024x320": (
        "https://storage.googleapis.com/niantic-lon-static/research/monodepth2/mono_1024x320.zip",
        "0ab0766efdfeea89a0d9ea8ba90e1e63"),
    "stereo_1024x320": (
        "https://storage.googleapis.com/niantic-lon-static/research/monodepth2/stereo_1024x320.zip",
        "afc2f2126d70cf3fdf26b550898b501a"),
    "mono+stereo_1024x320": (
        "https://storage.googleapis.com/niantic-lon-static/research/monodepth2/mono%2Bstereo_1024x320.zip",
        "cdc5fc9b23513c07d5b19235d9ef08f7"),
}


# torchvision ImageNet classification weights. The reference fetches these
# implicitly through torchvision's model zoo when it builds encoders with
# pretrained=True (networks/resnet_encoder.py:46-53, torchvision 0.9 per
# environment.yml); here the fetch is explicit and checksum-verified. Each
# filename embeds the first 8 sha256 hex chars (the torch.hub convention),
# which fetch_torchvision_resnet verifies after download.
TORCHVISION_RESNETS = {
    18: "https://download.pytorch.org/models/resnet18-5c106cde.pth",
    34: "https://download.pytorch.org/models/resnet34-333f7ec4.pth",
    50: "https://download.pytorch.org/models/resnet50-19c8e357.pth",
    101: "https://download.pytorch.org/models/resnet101-5d3b4d8f.pth",
    152: "https://download.pytorch.org/models/resnet152-b121ed2d.pth",
}


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def fetch_torchvision_resnet(num_layers: int, models_dir: str = "models") -> str:
    """Fetch the torchvision ImageNet resnet{num_layers} .pth (the implicit
    download the reference triggers at networks/resnet_encoder.py:46-53) and
    return its local path. Verified against the sha256 prefix embedded in
    the filename; an already-verified local copy is a no-op.
    """
    if num_layers not in TORCHVISION_RESNETS:
        raise KeyError(
            f"no torchvision resnet{num_layers}; known: {sorted(TORCHVISION_RESNETS)}"
        )
    url = TORCHVISION_RESNETS[num_layers]
    fname = url.rsplit("/", 1)[1]
    path = os.path.join(models_dir, fname)
    want_prefix = fname.rsplit("-", 1)[1].split(".")[0]
    if os.path.exists(path) and _sha256(path).startswith(want_prefix):
        return path
    os.makedirs(models_dir, exist_ok=True)
    import urllib.request

    print(f"-> downloading ImageNet weights {url} -> {path}")
    try:
        urllib.request.urlretrieve(url, path)
    except OSError as e:
        raise RuntimeError(
            f"ImageNet weight download failed ({e}); this environment may "
            f"have no network egress -- fetch {url} elsewhere, place it at "
            f"{path}, or pass --model.pretrained_path to a local .pth"
        ) from e
    got = _sha256(path)
    if not got.startswith(want_prefix):
        raise RuntimeError(
            f"checksum mismatch for {path}: sha256 {got[:8]}..., want prefix {want_prefix}"
        )
    return path


def download_model_if_doesnt_exist(
    model_name: str,
    models_dir: str = "models",
    url: str | None = None,
    md5: str | None = None,
) -> str:
    """Fetch + verify + unzip a checkpoint; returns the weights folder.

    model_name either keys MODEL_URLS or names the target folder for an
    explicit (url, md5) pair. Already-downloaded models are a no-op (the
    reference's behavior, utils.py:85-109).
    """
    if url is None:
        if model_name not in MODEL_URLS:
            raise KeyError(
                f"unknown model {model_name!r}; known: {sorted(MODEL_URLS)} "
                "(or pass an explicit url=)"
            )
        url, md5 = MODEL_URLS[model_name]

    os.makedirs(models_dir, exist_ok=True)
    model_path = os.path.join(models_dir, model_name)
    if os.path.exists(os.path.join(model_path, "encoder.pth")):
        return model_path

    zip_path = model_path + ".zip"
    have_zip = os.path.exists(zip_path)
    if have_zip and md5 is None:
        # Explicit --url with no checksum: trust the existing file rather
        # than re-fetching it (we could not verify the re-download either).
        print(f"-> {zip_path} exists and no md5 given; skipping re-download")
    if not (have_zip and (md5 is None or _md5(zip_path) == md5)):
        import urllib.request

        print(f"-> downloading {url} -> {zip_path}")
        try:
            urllib.request.urlretrieve(url, zip_path)
        except OSError as e:
            raise RuntimeError(
                f"download failed ({e}); this environment may have no "
                f"network egress -- fetch {url} elsewhere and place it at "
                f"{zip_path}"
            ) from e

    if md5 is not None:
        got = _md5(zip_path)
        if got != md5:
            raise RuntimeError(
                f"checksum mismatch for {zip_path}: got {got}, want {md5}"
            )

    with zipfile.ZipFile(zip_path) as zf:
        zf.extractall(model_path)
    print(f"-> model unpacked to {model_path}")
    return model_path


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Fetch published pretrained weights and (optionally) "
        "import them into this framework's parameter layout."
    )
    ap.add_argument("model_name", help="one of the known names, or a folder "
                    "name when --url is given")
    ap.add_argument("--models_dir", default="models")
    ap.add_argument("--url", default=None)
    ap.add_argument("--md5", default=None)
    ap.add_argument("--zoo", default=None,
                    help="also run the torch importer for this zoo and "
                    "report the imported parameter count")
    ap.add_argument("--num_layers", type=int, default=18,
                    help="the md2 encoder's ResNet depth, for --zoo md2")
    args = ap.parse_args(argv)

    folder = download_model_if_doesnt_exist(
        args.model_name, args.models_dir, url=args.url, md5=args.md5
    )
    print(folder)
    if args.zoo:
        from baseboostdepth_tpu_torch.models import build_depth_net, build_pose_net
        from baseboostdepth_tpu_torch.models.torch_import import IMPORTERS

        depth_net, pose_net = build_depth_net(args.zoo, args.num_layers), build_pose_net()
        IMPORTERS[args.zoo](folder, depth_net, pose_net)
        n = sum(p.numel() for net in (depth_net, pose_net) for p in net.parameters())
        print(f"imported {args.zoo} checkpoint: {n:,} parameters")


if __name__ == "__main__":
    main()
