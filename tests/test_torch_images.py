"""The port's ``utils/images.py`` against the JAX package's, byte for byte.

Both packages encode with the same PIL, so every helper must give the same
bytes (or raise the same error) on the same seeded images: the data URL, the
PNG normalization (PNG passes through, JPEG / BMP are re-encoded), the
bounded resize (a no-op when small, a clamp at 1 px for extreme aspect
ratios) and the page concatenation in both directions.
"""

import importlib
import io

import numpy as np
import pytest
from PIL import Image

JAX, TORCH = "autorag_research_tpu", "autorag_research_tpu_torch"


def both(name):
    return [getattr(importlib.import_module(f"{pkg}.utils.images"), name) for pkg in (JAX, TORCH)]


def _img(w, h, seed, fmt="PNG"):
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)).save(buf, format=fmt)
    return buf.getvalue()


@pytest.mark.parametrize("mimetype", ["image/png", "image/jpeg"])
def test_base64_url_equal(mimetype):
    jax_fn, torch_fn = both("image_to_base64_url")
    data = _img(5, 3, 0)
    assert torch_fn(data, mimetype) == jax_fn(data, mimetype)
    assert torch_fn(data).startswith("data:image/png;base64,")


@pytest.mark.parametrize("fmt", ["PNG", "JPEG", "BMP"])
def test_normalize_to_png_equal(fmt):
    jax_fn, torch_fn = both("normalize_to_png")
    data = _img(7, 5, 1, fmt)
    got = torch_fn(data)
    assert got == jax_fn(data)
    assert got[:8] == b"\x89PNG\r\n\x1a\n"
    if fmt == "PNG":
        assert got is data  # passthrough


@pytest.mark.parametrize("w,h,max_side", [(8, 6, 16), (40, 30, 16), (64, 2, 8), (1, 300, 10)])
def test_resize_image_equal(w, h, max_side):
    jax_fn, torch_fn = both("resize_image")
    data = _img(w, h, 2)
    got = torch_fn(data, max_side=max_side)
    assert got == jax_fn(data, max_side=max_side)
    out = Image.open(io.BytesIO(got))
    assert max(out.size) <= max(max_side, 1) and min(out.size) >= 1
    if max(w, h) <= max_side:
        assert got is data


@pytest.mark.parametrize("direction", ["horizontal", "vertical"])
def test_concatenate_images_equal(direction):
    jax_fn, torch_fn = both("concatenate_images")
    pages = [_img(4, 6, 3), _img(5, 2, 4, "JPEG"), _img(3, 3, 5)]
    got = torch_fn(pages, direction)
    assert got == jax_fn(pages, direction)
    size = Image.open(io.BytesIO(got)).size
    assert size == ((12, 6) if direction == "horizontal" else (5, 11))


@pytest.mark.parametrize("n_pages,direction,match", [
    (0, "horizontal", "no images"),
    (1, "diagonal", "unknown direction"),
])
def test_concatenate_images_errors_equal(n_pages, direction, match):
    pages = [_img(2, 2, 6)] * n_pages
    for fn in both("concatenate_images"):
        with pytest.raises(ValueError, match=match):
            fn(pages, direction)
