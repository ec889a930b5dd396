"""Writing an image file with whichever writer is importable.

The JAX package writes previews and renders with imageio. A machine may
have imageio, Pillow or neither; `write_image` takes the first it finds and
raises ImportError when there is none.
"""

from __future__ import annotations

import numpy as np


def write_image(path, img: np.ndarray) -> None:
    """img (H, W, 3) float in [0, 1] -> an 8-bit file at `path` (format by
    its suffix)."""
    img8 = (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)
    try:
        import imageio.v2 as imageio
    except ImportError:
        imageio = None
    if imageio is not None:
        imageio.imwrite(str(path), img8)
        return
    from PIL import Image  # ImportError when neither writer exists

    Image.fromarray(img8).save(str(path))
