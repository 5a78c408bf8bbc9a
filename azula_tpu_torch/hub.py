r"""Weight distribution: download, cache, verify, extract.

Port of :mod:`azula_tpu.hub`: a module-global cache directory, streaming hash
verification (`"alg:prefix"`), a `.part` file renamed into place, and tar/zip
extraction to a `<file>+x` directory. Downloads go through `urllib`; `gdown`
is imported only for Google-Drive links.

One difference: a cached file is named after the whole URL, sanitized, not
after its last path component, so that two URLs never share a file (the
`unet/` and `vae/` files of a diffusers repository have one basename).
"""

from __future__ import annotations

__all__ = [
    "download",
    "get_hub_dir",
    "set_hub_dir",
]

import hashlib
import os
import re
import shutil
import tarfile
import urllib.parse
import urllib.request
import zipfile

from pathlib import Path

from .utils.logging import get_logger

_HUB_DIR: Path | None = None


def get_hub_dir() -> Path:
    r"""Returns the cache directory for downloaded files
    (`~/.cache/azula_tpu_torch/hub` unless :func:`set_hub_dir` set one)."""

    if _HUB_DIR is None:
        return Path.home() / ".cache" / "azula_tpu_torch" / "hub"

    return _HUB_DIR


def set_hub_dir(path: str | Path) -> None:
    r"""Overrides the cache directory for downloaded files."""

    global _HUB_DIR
    _HUB_DIR = Path(path)


def cache_name(url: str) -> str:
    r"""The cache filename of a URL: its host, path and query (the scheme
    and fragment dropped), unquoted, with every character other than
    letters, digits, `.`, `-` and `+` replaced by `_`. A name longer than 200
    characters keeps its first 120 and last 60 around a hash of the URL."""

    parts = urllib.parse.urlparse(url)
    name = f"{parts.netloc}{parts.path}".strip("/")
    if parts.query:
        name = f"{name}?{parts.query}"
    name = re.sub(r"[^\w.\-+]", "_", urllib.parse.unquote(name))

    if len(name) > 200:
        name = f"{name[:120]}-{hashlib.sha256(url.encode()).hexdigest()[:16]}-{name[-60:]}"

    return name


def download(
    url: str,
    filename: str | None = None,
    hash_prefix: str | None = None,
    extract: bool = False,
    quiet: bool = False,
) -> Path:
    r"""Downloads a file into the hub cache, unless it is there already,
    optionally verifying its hash and extracting an archive.

    Arguments:
        url: The source URL. Google-Drive links go through `gdown`.
        filename: The cache filename. Defaults to :func:`cache_name` of `url`.
        hash_prefix: The expected content hash as `"alg:prefix"` (e.g.
            `"sha256:a3f2..."`); a mismatch raises.
        extract: Whether to extract a tar or zip archive; the extraction
            directory `<file>+x` is returned instead of the file.
        quiet: Whether to silence progress output.

    Returns:
        The path of the cached file (or of the extraction directory).
    """

    hub = get_hub_dir()
    hub.mkdir(parents=True, exist_ok=True)

    target = hub / (cache_name(url) if filename is None else filename)

    if not target.exists():
        if not quiet:
            get_logger("azula_tpu_torch.hub").info("downloading %s to %s", url, target)

        tmp = target.with_name(target.name + ".part")

        try:
            if "drive.google.com" in url:
                try:
                    import gdown
                except ImportError as e:
                    raise RuntimeError("Google-Drive downloads require the optional `gdown` package.") from e

                gdown.download(url, str(tmp), quiet=quiet)
            else:
                with urllib.request.urlopen(url) as response, open(tmp, "wb") as f:
                    shutil.copyfileobj(response, f)

            os.replace(tmp, target)
        finally:
            if tmp.exists():
                tmp.unlink()

    if hash_prefix is not None:
        alg, _, prefix = hash_prefix.partition(":")

        digest = hashlib.new(alg)
        with open(target, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                digest.update(chunk)

        if not digest.hexdigest().startswith(prefix):
            raise RuntimeError(
                f"hash mismatch for {target}: expected {alg} prefix {prefix}, got {digest.hexdigest()}"
            )

    if extract:
        out = target.with_name(target.name + "+x")

        if not out.exists():
            if tarfile.is_tarfile(target):
                with tarfile.open(target) as tar:
                    tar.extractall(out, filter="data")
            elif zipfile.is_zipfile(target):
                with zipfile.ZipFile(target) as zf:
                    zf.extractall(out)
            else:
                raise RuntimeError(f"{target} is not a recognized archive")

        return out

    return target
