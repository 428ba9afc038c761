"""The native JPEG path of the port (counterpart of cvnets_tpu/native/__init__.py,
with its public names): a batch of JPEG files decoded, cropped, resized and
mirrored straight into the collated uint8 ``(B, 3, H, W)`` batch.

On ``cuda`` the JPEGs are decoded by nvJPEG and resampled by one launch a
batch of the hand-written kernel of ``csrc/jpeg_decode.cu``, which follows the
JAX package's ``decode.cpp`` (``native/plain.py`` says how, and where the two
part); the batch comes back on the card. The library is built from the
source at first use (``ops/cuda_build.py``, linked with nvJPEG); a build,
decode-setup or launch failure raises. On ``cpu`` the plain version runs:
Pillow's decode and the same steps in torch ops (``native/plain.py``).

Crops are ``(x, y, w, h)`` in the original image's coordinates, ``w <= 0``
meaning the whole image; flips mirror the output. The status vector is 1 for
ok and 0 for a file that failed (its slot is zeros): unreadable, truncated
where the decoder notices, or four-component (CMYK).

A ``JpegDecoder`` owns nvJPEG handles and their JPEG states, one a chunk of
a batch decoded at once, and runs its chunks on the executor its owner gives
it (the train loader's threads); one caller uses it at a time (its lock).
The module's functions decode through the ``decoder`` their caller passes,
or through one made for the call. Nothing here builds, loads or touches the
card at import time.
"""

from __future__ import annotations

import ctypes
import threading
from concurrent.futures import Executor
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cvnets_tpu_torch.native import plain
from cvnets_tpu_torch.ops.cuda_build import KernelEntry

SOURCE = "jpeg_decode.cu"
N_PARAMS = 10  # a row of the kernel's params: offset, W, H, channels, crop (4), flip, ok
_NVJPEG_ERROR = 1000

# the hand-written crop -> resize -> flip kernel; counts its launches
crop_resize_flip_kernel = KernelEntry(
    SOURCE, "crop_resize_flip",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p])

_BINDINGS = {
    "jd_create": ([ctypes.POINTER(ctypes.c_void_p)], ctypes.c_int),
    "jd_destroy": ([ctypes.c_void_p], None),
    "jd_info": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int),
    "jd_decode": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int),
}
_LIB_LOCK = threading.Lock()
_LIB = None


def load_library() -> ctypes.CDLL:
    """The decode library, built from ``csrc/jpeg_decode.cu`` at first use
    (``nvcc`` on a machine with the CUDA toolkit; raises where it fails)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from cvnets_tpu_torch.ops.cuda_build import load_library as load

            lib = load(SOURCE)
            for name, (argtypes, restype) in _BINDINGS.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _LIB = lib
        return _LIB


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class _Blobs:
    """The pointer and length arrays of a list of byte strings (kept alive
    with them while a native call reads them)."""

    def __init__(self, blobs: Sequence[bytes]) -> None:
        self.blobs = list(blobs)
        n = len(self.blobs)
        self.ptrs = (ctypes.c_char_p * n)(*self.blobs)
        self.lens = (ctypes.c_size_t * n)(*[len(b) for b in self.blobs])


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


class JpegDecoder:
    """nvJPEG on one card: ``threads`` nvJPEG handles, each with its JPEG states
    (created at first use), which decode a batch's files in as many chunks,
    run on ``pool`` (an executor of at least ``threads`` workers that the
    owner keeps and shuts down) or one after another in the caller's thread
    without one (nvJPEG's default backend decodes the entropy code on the
    host, one core a call). One caller at a time (its lock)."""

    def __init__(self, device: Union[str, torch.device] = "cuda", threads: int = 1,
                 pool: Optional[Executor] = None) -> None:
        self.device = _device(device)
        if self.device.type != "cuda":
            raise ValueError(f"JpegDecoder decodes on a CUDA card, not {self.device}")
        self.threads = max(1, int(threads))
        self._pool = pool
        self._lock = threading.Lock()
        self._decs: list = []

    def _handles(self) -> list:
        if not self._decs:
            lib = load_library()
            with torch.cuda.device(self.device):
                for _ in range(self.threads):
                    dec = ctypes.c_void_p()
                    err = lib.jd_create(ctypes.byref(dec))
                    if err != 0:
                        raise RuntimeError(
                            f"nvJPEG setup failed: nvjpegStatus_t {err - _NVJPEG_ERROR}")
                    self._decs.append(dec)
        return self._decs

    def info(self, blobs: Sequence[bytes]) -> np.ndarray:
        """(N, 3) int32: each header's width, height and components (0s where
        nvJPEG cannot read it)."""
        b = _Blobs(blobs)
        out = np.zeros((3, len(b.blobs)), np.int32)
        with self._lock:
            load_library().jd_info(self._handles()[0], b.ptrs, b.lens, len(b.blobs),
                                   _ptr(out[0]), _ptr(out[1]), _ptr(out[2]))
        return out.T.copy()

    def decode_rrc(self, blobs: Sequence[bytes], crops: Sequence[Tuple[int, int, int, int]],
                   flips: Optional[Sequence[bool]], out_hw: Tuple[int, int]
                   ) -> Tuple[torch.Tensor, np.ndarray]:
        """The batch (uint8 (B, 3, H, W) on the card, enqueued on the current
        stream) and its status (bool (B,), on the host)."""
        info = self.info(blobs)
        offsets, total = raster_layout(info)
        raster, status = self.decode(blobs, info, offsets, total)
        params = kernel_params(info, offsets, crops, flips, status)
        return crop_resize_flip(raster, torch.from_numpy(params), out_hw), status.astype(bool)

    def decode(self, blobs: Sequence[bytes], info: np.ndarray, offsets: np.ndarray,
               total: int) -> Tuple[torch.Tensor, np.ndarray]:
        """nvJPEG's rasters of ``blobs`` (``info`` from ``info``) in one uint8
        card buffer at ``offsets`` (H × W × 3 interleaved RGB, or H × W luma for
        a grayscale file), enqueued on the current stream, and the int32 status."""
        n = len(blobs)
        raster = torch.empty(max(total, 1), dtype=torch.uint8, device=self.device)
        status = np.zeros(n, np.int32)
        comps = np.ascontiguousarray(info[:, 2])
        ws = np.ascontiguousarray(info[:, 0])
        offsets = np.ascontiguousarray(offsets, np.int64)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        lib = load_library()

        def chunk(k: int, lo: int, hi: int) -> int:  # files lo..hi-1 on handle k
            b = _Blobs(blobs[lo:hi])
            with torch.cuda.device(self.device):
                return lib.jd_decode(self._decs[k], b.ptrs, b.lens, hi - lo,
                                     _ptr(comps[lo:]), _ptr(ws[lo:]), raster.data_ptr(),
                                     _ptr(offsets[lo:]), _ptr(status[lo:]), stream)

        with self._lock:
            self._handles()
            bounds = np.linspace(0, n, min(self.threads, max(n, 1)) + 1).astype(int)
            jobs = [(k, int(lo), int(hi)) for k, (lo, hi) in enumerate(zip(bounds, bounds[1:]))]
            errs = (list(self._pool.map(lambda j: chunk(*j), jobs)) if self._pool is not None
                    and len(jobs) > 1 else [chunk(*j) for j in jobs])
        if any(errs):
            raise RuntimeError(f"nvJPEG decode failed: cudaError {max(errs)}")
        return raster, status

    def close(self) -> None:
        with self._lock:
            self._release()

    def _release(self) -> None:
        while self._decs:
            _LIB.jd_destroy(self._decs.pop())

    def __del__(self) -> None:
        if getattr(self, "_decs", None) and _LIB is not None:
            self._release()


def raster_layout(info: np.ndarray) -> Tuple[np.ndarray, int]:
    """(int64 offsets, total bytes) of the rasters of ``info`` (``JpegDecoder.info``)
    in one buffer: H × W × 3, or H × W for a grayscale file; none for a file
    that cannot be decoded."""
    comps = info[:, 2]
    sizes = np.where((comps == 1) | (comps == 3),
                     info[:, 0].astype(np.int64) * info[:, 1] * np.where(comps == 1, 1, 3), 0)
    return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64), int(sizes.sum())


def kernel_params(info: np.ndarray, offsets: np.ndarray, crops, flips,
                  status: np.ndarray) -> np.ndarray:
    """The kernel's (B, 10) int64 params: raster offset, W, H, channels, the
    crop's x, y, w, h, flip, status."""
    n = len(crops)
    params = np.zeros((n, N_PARAMS), np.int64)
    params[:, 0], params[:, 1], params[:, 2] = offsets, info[:, 0], info[:, 1]
    params[:, 3] = np.where(info[:, 2] == 1, 1, 3)
    params[:, 4:8] = np.asarray(crops, np.int64).reshape(n, 4)
    params[:, 8] = 0 if flips is None else np.asarray(flips, bool)
    params[:, 9] = status
    return params


def crop_resize_flip(raster: torch.Tensor, params: torch.Tensor, out_hw: Tuple[int, int]
                     ) -> torch.Tensor:
    """The kernel's launch: ``raster`` the batch's rasters in one uint8 card
    buffer, ``params`` (B, 10) int64 (offset, W, H, channels, crop x, y, w, h,
    flip, ok; on the host, sent up from pinned memory). Returns uint8 (B, 3, H,
    W) on the raster's card, enqueued on the current stream."""
    if raster.device.type != "cuda":
        raise ValueError("crop_resize_flip launches on a CUDA tensor; the CPU path is "
                         "native.plain.crop_resize_flip")
    if raster.dtype != torch.uint8 or not raster.is_contiguous():
        raise ValueError(f"raster: {raster.dtype}, contiguous {raster.is_contiguous()}")
    if params.dtype != torch.int64 or params.dim() != 2 or params.shape[1] != N_PARAMS:
        raise ValueError(f"params: {params.dtype} {tuple(params.shape)}")
    out_h, out_w = (int(v) for v in out_hw)
    n = params.shape[0]
    dev_params = params.pin_memory().to(raster.device, non_blocking=True)
    out = torch.empty((n, 3, out_h, out_w), dtype=torch.uint8, device=raster.device)
    crop_resize_flip_kernel.launch(raster.device, raster.data_ptr(), dev_params.data_ptr(),
                                   n, out_h, out_w, out.data_ptr())
    return out


def _on_card(device: torch.device, decoder: Optional[JpegDecoder], call):
    """``call(decoder)``, through a decoder made for it, and closed after its
    work is done, where the caller passes none."""
    if decoder is not None:
        return call(decoder)
    decoder = JpegDecoder(device)
    try:
        return call(decoder)
    finally:  # nvJPEG's states may still be in use on the stream
        torch.cuda.current_stream(device).synchronize()
        decoder.close()


def jpeg_dimensions_batch(blobs: Sequence[bytes], device: Union[str, torch.device] = "cuda",
                          decoder: Optional[JpegDecoder] = None) -> np.ndarray:
    """(N, 2) int32 of each header's (width, height), (0, 0) where it cannot be
    read: nvJPEG's header parser on ``cuda``, Pillow's on ``cpu``."""
    device = _device(device)
    if device.type == "cpu":
        return np.asarray(plain.dimensions_plain(blobs), np.int32).reshape(-1, 2)
    return _on_card(device, decoder, lambda d: d.info(blobs)[:, :2].copy())


def jpeg_dimensions(data: bytes, device: Union[str, torch.device] = "cuda"
                    ) -> Optional[Tuple[int, int]]:
    """(width, height) from the JPEG header, or None."""
    w, h = jpeg_dimensions_batch([data], device)[0]
    return (int(w), int(h)) if w > 0 and h > 0 else None


def decode_rrc_batch(blobs: Sequence[bytes], crops: Sequence[Tuple[int, int, int, int]],
                     flips: Optional[Sequence[bool]], out_hw: Tuple[int, int],
                     device: Union[str, torch.device] = "cuda",
                     decoder: Optional[JpegDecoder] = None
                     ) -> Tuple[torch.Tensor, np.ndarray]:
    """Decode, crop, resize to ``out_hw`` and mirror (``flips``, or None) a
    batch of JPEGs: (uint8 (B, 3, H, W) on ``device``, bool (B,) status on the
    host). On a card the work is enqueued on the current stream (and done
    before the call returns where a decoder is made for it)."""
    device = _device(device)
    if len(blobs) != len(crops) or (flips is not None and len(flips) != len(blobs)):
        raise ValueError(f"{len(blobs)} blobs, {len(crops)} crops, "
                         f"{None if flips is None else len(flips)} flips")
    if device.type == "cpu":
        return plain.decode_rrc_batch_plain(blobs, crops, flips, out_hw)
    if device.type != "cuda":
        raise ValueError(f"the native decoder runs on cuda or cpu, not {device}")
    return _on_card(device, decoder, lambda d: d.decode_rrc(blobs, crops, flips, out_hw))


def decode_crop_resize_batch(blobs: Sequence[bytes],
                             crops: Optional[Sequence[Tuple[int, int, int, int]]],
                             out_hw: Tuple[int, int],
                             device: Union[str, torch.device] = "cuda"
                             ) -> Tuple[torch.Tensor, np.ndarray]:
    """``decode_rrc_batch`` without flips; ``crops`` None: whole images."""
    if crops is None:
        crops = [(0, 0, -1, -1)] * len(blobs)
    return decode_rrc_batch(blobs, crops, None, out_hw, device)
