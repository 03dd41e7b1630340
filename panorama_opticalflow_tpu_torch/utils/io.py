"""Image file I/O of the port: PNG and TIFF with alpha.

The reference wraps cv::imread/imwrite with exceptions
(CPU/util.cpp:19-46).  ``read_image_rgba`` and ``write_image`` use PIL;
``read_image_rgba_fast`` and ``write_image_fast`` use the native C++
codec of ``native/panoio.cpp`` (libpng/libtiff behind a plain C
interface, bound with ``ctypes``) for PNG and TIFF, and PIL where the
codec does not build or does not take the file.  The codec is built by
``native/build.sh`` on first use; nothing is built or loaded when this
module is imported.  ``PrefetchLoader`` decodes the next inputs on a
background thread while the device stitches the current ones.
"""

from __future__ import annotations

import ctypes
import os
import queue
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")

_lib = None
_tried = False


class PanoIOError(RuntimeError):
    """Image read/write failure (the reference's VrCamException)."""


def read_image_rgba(path: str) -> np.ndarray:
    """Read an image file as (H, W, 4) uint8 RGBA; raises on failure
    (imreadExceptionOnFail, CPU/util.cpp:19-26).  3-channel inputs get an
    opaque alpha like the reference's CV_8UC3 -> BGRA promotion
    (CPU/main.cpp:58)."""
    from PIL import Image

    if not os.path.exists(path):
        raise PanoIOError(f"failed to load image: {path}")
    try:
        img = Image.open(path)
        img = img.convert("RGBA")
    except Exception as e:  # noqa: BLE001
        raise PanoIOError(f"failed to load image: {path}: {e}") from e
    return np.asarray(img, np.uint8)


def write_image(path: str, img: np.ndarray) -> None:
    """Write (H, W, 4) or (H, W, 3) uint8; raises on failure
    (imwriteExceptionOnFail, CPU/util.cpp:28-34)."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        Image.fromarray(np.asarray(img)).save(path)
    except Exception as e:  # noqa: BLE001
        raise PanoIOError(f"failed to write image: {path}: {e}") from e


def _load():
    """The native codec library, or None where it is missing and does not
    build (then PIL does the work)."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = os.path.join(_NATIVE_DIR, "libpanoio.so")
    build = os.path.join(_NATIVE_DIR, "build.sh")
    if not os.path.exists(path) and os.path.exists(build):
        try:
            subprocess.run(["sh", build], check=True, capture_output=True,
                           timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    int_p = ctypes.POINTER(ctypes.c_int)
    lib.panoio_png_decode.restype = ctypes.c_int
    lib.panoio_png_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_void_p, int_p, int_p]
    lib.panoio_png_encode.restype = ctypes.c_long
    lib.panoio_png_encode.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_size_t]
    lib.panoio_tiff_decode.restype = ctypes.c_int
    lib.panoio_tiff_decode.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                       int_p, int_p]
    lib.panoio_tiff_encode.restype = ctypes.c_int
    lib.panoio_tiff_encode.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_int]
    _lib = lib
    return lib


def _decode(what: str, call) -> np.ndarray:
    """Two calls of a native decoder: the first reports the size, the
    second fills the (H, W, 4) buffer."""
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = call(None, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"{what} decode failed: {rc}")
    out = np.empty((h.value, w.value, 4), np.uint8)
    rc = call(out.ctypes.data_as(ctypes.c_void_p), ctypes.byref(h),
              ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"{what} decode failed: {rc}")
    return out


def _png_encode(lib, img: np.ndarray, compress_level: int) -> bytes:
    ptr = img.ctypes.data_as(ctypes.c_void_p)
    cap = img.nbytes + (1 << 16)
    buf = ctypes.create_string_buffer(cap)
    n = lib.panoio_png_encode(ptr, img.shape[0], img.shape[1],
                              compress_level, buf, cap)
    if n < 0:   # the codec asks for a larger buffer
        cap = -n
        buf = ctypes.create_string_buffer(cap)
        n = lib.panoio_png_encode(ptr, img.shape[0], img.shape[1],
                                  compress_level, buf, cap)
    if n < 0:
        raise ValueError(f"png encode failed: {n}")
    return buf.raw[:n]


def _is_tiff(path: str) -> bool:
    return path.lower().endswith((".tif", ".tiff"))


def read_image_rgba_fast(path: str) -> np.ndarray:
    """Native-codec read for PNG and TIFF; PIL for everything else."""
    lib = _load()
    if lib is not None and os.path.exists(path):
        if path.lower().endswith(".png"):
            with open(path, "rb") as f:
                data = f.read()
            return _decode("png", lambda *a: lib.panoio_png_decode(
                data, len(data), *a))
        if _is_tiff(path):
            try:
                return _decode("tiff", lambda *a: lib.panoio_tiff_decode(
                    path.encode(), *a))
            except ValueError:
                pass  # a TIFF flavour the codec does not take: PIL reads it
    return read_image_rgba(path)


def write_image_fast(path: str, img: np.ndarray,
                     compress_level: int = 1) -> None:
    """Native-codec write of (H, W, 4) uint8 PNG and TIFF; PIL for
    everything else."""
    lib = _load()
    rgba = img.ndim == 3 and img.shape[2] == 4
    if lib is not None and rgba and (path.lower().endswith(".png")
                                     or _is_tiff(path)):
        img = np.ascontiguousarray(img, np.uint8)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if _is_tiff(path):
            rc = lib.panoio_tiff_encode(
                path.encode(), img.ctypes.data_as(ctypes.c_void_p),
                img.shape[0], img.shape[1])
            if rc != 0:
                raise ValueError(f"tiff encode failed: {rc}")
        else:
            data = _png_encode(lib, img, compress_level)
            with open(path, "wb") as f:
                f.write(data)
        return
    write_image(path, img)


class PrefetchLoader:
    """Background-thread image loader: iterating yields (path, image) in
    the order of ``paths``, at most ``depth`` decoded ahead; a failed read
    is raised where its image would have been yielded."""

    def __init__(self, paths: list[str], depth: int = 2):
        self._paths = paths
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for p in self._paths:
            try:
                self._q.put((p, read_image_rgba_fast(p)))
            except Exception as e:  # noqa: BLE001
                self._q.put((p, e))
        self._q.put((None, None))

    def __iter__(self):
        while True:
            p, img = self._q.get()
            if p is None:
                return
            if isinstance(img, Exception):
                raise img
            yield p, img
