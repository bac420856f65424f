"""Image I/O (PNG/JPG via OpenCV, or PIL when OpenCV is absent). BGR u8,
like the reference's cv::imread-based samples.  Neither package is needed
by the library itself; they are imported only when a file is read or
written."""

from __future__ import annotations

import numpy as np


def _backend():
    """The cv2 module, or PIL.Image when cv2 is absent."""
    try:
        import cv2
        return cv2
    except ImportError:
        pass
    try:
        from PIL import Image
        return Image
    except ImportError:
        raise ImportError("image I/O needs OpenCV (the cv2 package) or "
                          "Pillow (the PIL package); neither is installed"
                          ) from None


def _cv2_read(cv2, path: str, flag) -> np.ndarray:
    img = cv2.imread(path, flag)
    if img is None:
        raise FileNotFoundError(path)
    return np.asarray(img)


def imread(path: str) -> np.ndarray:
    lib = _backend()
    if lib.__name__ == "cv2":
        return _cv2_read(lib, path, lib.IMREAD_COLOR)
    rgb = np.asarray(lib.open(path).convert("RGB"))
    return rgb[:, :, ::-1].copy()  # → BGR


def imread_gray(path: str) -> np.ndarray:
    lib = _backend()
    if lib.__name__ == "cv2":
        return _cv2_read(lib, path, lib.IMREAD_GRAYSCALE)
    return np.asarray(lib.open(path).convert("L"))


def imwrite(path: str, img: np.ndarray) -> None:
    img = np.asarray(img)
    lib = _backend()
    if lib.__name__ == "cv2":
        lib.imwrite(path, img)
        return
    if img.ndim == 3:
        img = img[:, :, ::-1]  # BGR → RGB
    lib.fromarray(img).save(path)
