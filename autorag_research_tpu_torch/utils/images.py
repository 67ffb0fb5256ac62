"""Image helpers for multimodal pipelines.

Role parity with the reference's image utilities (``util.py:267-369``):
base64 data-URL encoding for vision LLM payloads, PNG normalization, and
bounded resizing to keep VLM payloads small.

The port's copy of the JAX package's ``utils/images.py``. PIL is imported
inside each function, so the module imports where PIL is not installed.
"""

from __future__ import annotations

import base64
import io


def image_to_base64_url(image_bytes: bytes, mimetype: str = "image/png") -> str:
    return f"data:{mimetype};base64,{base64.b64encode(image_bytes).decode()}"


def normalize_to_png(image_bytes: bytes) -> bytes:
    """Re-encode any PIL-readable image as PNG (passthrough if already PNG)."""
    if image_bytes[:8] == b"\x89PNG\r\n\x1a\n":
        return image_bytes
    from PIL import Image

    img = Image.open(io.BytesIO(image_bytes)).convert("RGB")
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def resize_image(image_bytes: bytes, max_side: int = 1024) -> bytes:
    """Downscale so the longest side <= max_side (no-op when already small)."""
    from PIL import Image

    img = Image.open(io.BytesIO(image_bytes))
    w, h = img.size
    if max(w, h) <= max_side:
        return image_bytes
    scale = max_side / max(w, h)
    # clamp at 1px: extreme aspect ratios (e.g. a 1x4096 strip) would round
    # the short side to 0 and crash PIL
    img = img.convert("RGB").resize(
        (max(1, int(w * scale)), max(1, int(h * scale)))
    )
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def concatenate_images(
    images: list[bytes], direction: str = "horizontal"
) -> bytes:
    """Merge page images into ONE composite PNG (the reference VisRAG
    ``image_processing_mode="concatenate"`` fallback for single-image VLMs,
    ``pipelines/generation/visrag_gen.py:40-43``)."""
    import io

    from PIL import Image

    if not images:
        raise ValueError("no images to concatenate")
    pils = [Image.open(io.BytesIO(b)).convert("RGB") for b in images]
    if direction == "horizontal":
        h = max(im.height for im in pils)
        w = sum(im.width for im in pils)
        canvas = Image.new("RGB", (w, h), "white")
        x = 0
        for im in pils:
            canvas.paste(im, (x, 0))
            x += im.width
    elif direction == "vertical":
        w = max(im.width for im in pils)
        h = sum(im.height for im in pils)
        canvas = Image.new("RGB", (w, h), "white")
        y = 0
        for im in pils:
            canvas.paste(im, (0, y))
            y += im.height
    else:
        raise ValueError(f"unknown direction '{direction}'")
    out = io.BytesIO()
    canvas.save(out, format="PNG")
    return out.getvalue()
