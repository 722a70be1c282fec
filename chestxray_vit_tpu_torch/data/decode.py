"""Image decode stage of the port: bytes → u8 grayscale array, a copy of
``chestxray_vit_tpu/data/decode.py`` (the parts serving and the loader
call; the batch decoder ``decode_batch_native`` is not copied: no caller).

Same contract as the reference's PIL decode in ``__getitem__``
(``Image.open(...).convert('L')``, a black dummy on any failure), with two
engines:

- the C++ decoder ``native/decode/libcxrdecode.so`` (libpng/libjpeg, built
  by ``make -C native/decode``), loaded with ctypes when it is built;
- PIL otherwise.

Both give the same luminance (ITU-R 601-2 'L' conversion for RGB inputs,
the high byte of 16-bit grayscale).
"""

from __future__ import annotations

import ctypes
import io
import os
import threading
from typing import Optional, Tuple

import numpy as np

_NATIVE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "decode", "libcxrdecode.so")

_native_lock = threading.Lock()
_native_lib: Optional[ctypes.CDLL] = None
_native_checked = False


def _load_native() -> Optional[ctypes.CDLL]:
    """Load the C++ decoder once; None when it isn't built (or is stale)."""
    global _native_lib, _native_checked
    with _native_lock:
        if _native_checked:
            return _native_lib
        _native_checked = True
        if not os.path.exists(_NATIVE_PATH):
            return None
        try:
            lib = ctypes.CDLL(_NATIVE_PATH)
            lib.cxr_decode_gray.restype = ctypes.c_int
            lib.cxr_decode_gray.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,          # input bytes
                ctypes.POINTER(ctypes.c_ubyte),            # output buffer
                ctypes.c_int, ctypes.c_int,                # buffer H, W
                ctypes.POINTER(ctypes.c_int),              # out H
                ctypes.POINTER(ctypes.c_int),              # out W
            ]
            lib.cxr_crop_pad_resize.restype = ctypes.c_int
            lib.cxr_crop_pad_resize.argtypes = [
                ctypes.POINTER(ctypes.c_ubyte),            # input image
                ctypes.c_int, ctypes.c_int,                # in H, W
                ctypes.c_size_t,                           # in row stride
                ctypes.c_int, ctypes.c_int,                # crop left, top
                ctypes.c_int, ctypes.c_int,                # crop W, H
                ctypes.c_int, ctypes.c_int,                # stretch, flip
                ctypes.POINTER(ctypes.c_ubyte),            # output buffer
                ctypes.c_int,                              # out size
            ]
            _native_lib = lib
        except (OSError, AttributeError) as e:
            # unloadable, or a stale build missing a symbol: PIL serves
            print(f"[decode] native decoder unavailable ({e}); rebuild with "
                  "`make -C native/decode`")
            _native_lib = None
        return _native_lib


def native_available() -> bool:
    return _load_native() is not None


def decode_gray_pil(data: bytes) -> np.ndarray:
    """PIL engine: any format PIL reads → u8 grayscale [H, W]."""
    from PIL import Image
    with Image.open(io.BytesIO(data)) as img:
        if img.mode in ("I", "I;16", "I;16L", "I;16B"):
            # 16-bit grayscale: the high byte, as libpng's png_set_strip_16
            # gives the native engine (PIL's convert('L') would clamp)
            arr = np.asarray(img, dtype=np.uint32)
            return (arr >> 8).astype(np.uint8)
        return np.asarray(img.convert("L"), dtype=np.uint8)


def decode_gray_native(data: bytes, max_side: int = 4096
                       ) -> Optional[np.ndarray]:
    """C++ engine: PNG/JPEG → u8 grayscale; None on failure or when the
    library isn't built (callers fall back to PIL)."""
    lib = _load_native()
    if lib is None:
        return None
    buf = np.empty((max_side, max_side), dtype=np.uint8)
    out_h = ctypes.c_int(0)
    out_w = ctypes.c_int(0)
    rc = lib.cxr_decode_gray(
        data, len(data),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        max_side, max_side,
        ctypes.byref(out_h), ctypes.byref(out_w))
    if rc != 0:
        return None
    return buf[:out_h.value, :out_w.value].copy()


def decode_gray(data: bytes, prefer_native: bool = True) -> np.ndarray:
    """Decode to u8 grayscale, native first, PIL fallback. Raises only if
    both engines fail (callers apply the dummy-image policy)."""
    if prefer_native:
        out = decode_gray_native(data)
        if out is not None:
            return out
    return decode_gray_pil(data)


def crop_pad_resize_native(gray: np.ndarray, left: int, top: int, cw: int,
                           ch: int, out_size: int, stretch: bool = False,
                           flip: bool = False) -> Optional[np.ndarray]:
    """C++ crop → centered pad-to-square → PIL-BILINEAR-exact resize →
    optional horizontal flip. None when the library isn't built or on bad
    arguments (callers fall back to the PIL path)."""
    lib = _load_native()
    if lib is None:
        return None
    gray = np.ascontiguousarray(gray, dtype=np.uint8)
    h, w = gray.shape
    out = np.empty((out_size, out_size), dtype=np.uint8)
    rc = lib.cxr_crop_pad_resize(
        gray.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), h, w, w,
        int(left), int(top), int(cw), int(ch),
        int(bool(stretch)), int(bool(flip)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), out_size)
    if rc != 0:
        return None
    return out


def dummy_image(size: Tuple[int, int] = (384, 384)) -> np.ndarray:
    """The reference's failure fallback: a black 'L' image."""
    return np.zeros(size, dtype=np.uint8)


def safe_decode_gray(data: Optional[bytes],
                     dummy_size: Tuple[int, int] = (384, 384),
                     prefer_native: bool = True) -> np.ndarray:
    """Decode with the reference's degrade-to-dummy policy."""
    if data is None:
        return dummy_image(dummy_size)
    try:
        return decode_gray(data, prefer_native=prefer_native)
    except Exception as e:                                 # noqa: BLE001
        print(f"[decode] failed ({e}); using dummy image")
        return dummy_image(dummy_size)
