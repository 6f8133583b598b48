"""Audio read and write, bit-compatible with the JAX package's native
reader and writer (``native/audio_io.cpp``): WAV with numpy, Ogg/Vorbis
through libvorbis.

Read returns float32 arrays shaped like ``soundfile.read``: (n,) for mono,
(n, channels) otherwise, with ``start``/``stop`` frame offsets. PCM16 is
read as int16 / 32768 and written as ``(int16)(clip(v, -1, 1) * 32767)``
(truncated toward zero), as the native library does; PCM24/PCM32 and
32-bit float WAVs are read too.

The port does not load ``native/``. ``.ogg`` goes through the port's own
copy of its Vorbis half, ``csrc/ogg_io.cpp``, which g++ builds at first use
into ``svecalign_tpu_torch/build/`` against the system's
:data:`VORBIS_LIBS`, bound with ctypes. Where g++ or those libraries are
missing, ``.ogg`` raises and names them; nothing reads or writes another
format in its place.
"""

import ctypes
import struct
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from svecalign_tpu_torch.ops._build import BUILD_DIR, build_host_library

VORBIS_LIBS = ("libvorbisfile.so.3", "libvorbisenc.so.2", "libvorbis.so.0", "libogg.so.0")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_ogg_lock = threading.Lock()
_ogg_lib: Optional[ctypes.CDLL] = None


class _WavInfo:
    __slots__ = ("sample_rate", "channels", "bits", "fmt", "data_offset", "frames")


def _is_ogg(path) -> bool:
    return str(path).endswith(".ogg")


def _build_ogg_library() -> Path:
    """``build/libogg_io-<digest>.so``, built by g++ against
    :data:`VORBIS_LIBS` unless it is built."""
    link = ["-L/usr/lib/x86_64-linux-gnu"] + [f"-l:{lib}" for lib in VORBIS_LIBS]
    try:
        return build_host_library("ogg_io", GXX_FLAGS, link, BUILD_DIR)
    except RuntimeError as e:
        raise RuntimeError(f".ogg needs g++ and the system's {', '.join(VORBIS_LIBS)}: "
                           f"{e}") from e


def _ogg() -> ctypes.CDLL:
    global _ogg_lib
    with _ogg_lock:
        if _ogg_lib is None:
            try:
                lib = ctypes.CDLL(str(_build_ogg_library()))
            except OSError as e:
                raise RuntimeError(f".ogg needs the system's {', '.join(VORBIS_LIBS)}: {e}") from e
            lib.sva_ogg_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int64),
                                         ctypes.POINTER(ctypes.c_int)]
            lib.sva_ogg_info.restype = ctypes.c_int
            lib.sva_ogg_read.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.POINTER(ctypes.c_float)]
            lib.sva_ogg_read.restype = ctypes.c_int64
            lib.sva_ogg_write.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                          ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_float]
            lib.sva_ogg_write.restype = ctypes.c_int
            _ogg_lib = lib
    return _ogg_lib


def _ogg_info(path: str) -> Tuple[int, int, int]:
    sr, frames, ch = ctypes.c_int(), ctypes.c_int64(), ctypes.c_int()
    ret = _ogg().sva_ogg_info(str(path).encode(), ctypes.byref(sr), ctypes.byref(frames),
                              ctypes.byref(ch))
    if ret != 0:
        raise IOError(f"cannot read audio info from {path} (code {ret})")
    return sr.value, frames.value, ch.value


def _ogg_read(path: str, start: int, stop: Optional[int]) -> Tuple[np.ndarray, int]:
    sr, total, ch = _ogg_info(path)
    if stop is None or stop > total:
        stop = total
    count = max(stop - start, 0)
    out = np.empty(count * ch, dtype=np.float32)
    if count:
        got = _ogg().sva_ogg_read(str(path).encode(), start, count,
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if got < 0:
            raise IOError(f"failed to read {path} (code {got})")
        if got < count:
            out = out[: got * ch]
            count = got
    wav = out.reshape(count, ch)
    return (wav[:, 0] if ch == 1 else wav), sr


def _ogg_write(path: str, wav: np.ndarray, sample_rate: int, quality: float) -> None:
    frames, ch = wav.shape
    ret = _ogg().sva_ogg_write(str(path).encode(),
                               wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               frames, ch, sample_rate, quality)
    if ret != 0:
        raise IOError(f"failed to write {path} (code {ret})")


def _parse_header(fp, path) -> _WavInfo:
    hdr = fp.read(12)
    if len(hdr) != 12 or hdr[:4] != b"RIFF" or hdr[8:12] != b"WAVE":
        raise IOError(f"{path}: not a RIFF/WAVE file")
    info = _WavInfo()
    info.sample_rate = 0
    while True:
        chunk = fp.read(8)
        if len(chunk) != 8:
            raise IOError(f"{path}: no data chunk")
        tag, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
        if tag == b"fmt ":
            body = fp.read(size)
            if len(body) != size or size < 16:
                raise IOError(f"{path}: truncated fmt chunk")
            fmt, ch, rate = struct.unpack("<HHI", body[:8])
            bits = struct.unpack("<H", body[14:16])[0]
            if fmt == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                fmt = struct.unpack("<H", body[24:26])[0]
            info.fmt, info.channels, info.sample_rate, info.bits = fmt, ch, rate, bits
        elif tag == b"data":
            if info.sample_rate <= 0:
                raise IOError(f"{path}: data chunk before fmt chunk")
            info.data_offset = fp.tell()
            info.frames = size // (info.channels * info.bits // 8)
            return info
        else:
            fp.seek((size + 1) & ~1, 1)  # chunks are word-aligned


def info(path: str) -> Tuple[int, int, int]:
    """Return (sample_rate, frames, channels)."""
    if _is_ogg(path):
        return _ogg_info(path)
    with open(path, "rb") as fp:
        wi = _parse_header(fp, path)
    return wi.sample_rate, wi.frames, wi.channels


def read(path: str, start: int = 0, stop: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Read frames [start, stop) as float32. Returns (waveform, sample_rate)."""
    if _is_ogg(path):
        return _ogg_read(path, start, stop)
    with open(path, "rb") as fp:
        wi = _parse_header(fp, path)
        if stop is None or stop > wi.frames:
            stop = wi.frames
        start = min(start, wi.frames)
        count = max(stop - start, 0)
        width = wi.bits // 8
        fp.seek(wi.data_offset + start * wi.channels * width)
        raw = fp.read(count * wi.channels * width)
    if len(raw) != count * wi.channels * width:
        raise IOError(f"{path}: truncated data chunk")
    if wi.fmt == 3 and wi.bits == 32:
        out = np.frombuffer(raw, "<f4").astype(np.float32)
    elif wi.fmt == 1 and wi.bits == 16:
        out = np.frombuffer(raw, "<i2").astype(np.float32) / np.float32(32768.0)
    elif wi.fmt == 1 and wi.bits == 32:
        out = np.frombuffer(raw, "<i4").astype(np.float32) / np.float32(2147483648.0)
    elif wi.fmt == 1 and wi.bits == 24:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        v = (b[:, 0] << 8) | (b[:, 1] << 16) | (b[:, 2] << 24)
        out = (v >> 8).astype(np.float32) / np.float32(8388608.0)
    else:
        raise IOError(f"{path}: unsupported WAV encoding (format {wi.fmt}, {wi.bits} bits)")
    wav = out.reshape(count, wi.channels)
    if wi.channels == 1:
        wav = wav[:, 0]
    return wav, wi.sample_rate


def write(path: str, waveform: np.ndarray, sample_rate: int, quality: float = 0.4) -> None:
    """Write a float32 waveform ((n,) or (n, ch)) as .ogg (Vorbis VBR at
    ``quality``) or else as 16-bit PCM WAV."""
    wav = np.ascontiguousarray(waveform, dtype=np.float32)
    if wav.ndim == 1:
        wav = wav[:, None]
    if _is_ogg(path):
        _ogg_write(path, wav, sample_rate, quality)
        return
    frames, ch = wav.shape
    pcm = (np.clip(wav, -1.0, 1.0) * np.float32(32767.0)).astype("<i2")  # truncates
    data_bytes = frames * ch * 2
    header = b"RIFF" + struct.pack("<I", 36 + data_bytes) + b"WAVE"
    header += b"fmt " + struct.pack("<IHHIIHH", 16, 1, ch, sample_rate,
                                    sample_rate * ch * 2, ch * 2, 16)
    header += b"data" + struct.pack("<I", data_bytes)
    Path(path).write_bytes(header + pcm.tobytes())
