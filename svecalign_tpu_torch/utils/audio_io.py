"""WAV read and write with numpy, bit-compatible with the JAX package's
native reader and writer (``native/audio_io.cpp``).

Read returns float32 arrays shaped like ``soundfile.read``: (n,) for mono,
(n, channels) otherwise, with ``start``/``stop`` frame offsets. PCM16 is
read as int16 / 32768 and written as ``(int16)(clip(v, -1, 1) * 32767)``
(truncated toward zero), as the native library does; PCM24/PCM32 and
32-bit float WAVs are read too.

The port does not load ``native/``. Ogg/Vorbis needs libvorbis, which the
port does not bind yet: ``.ogg`` raises, naming its ROADMAP item.
"""

import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

OGG_TODO = "ROADMAP.md Queue 1 item 12a (.ogg decode in the port)"


class _WavInfo:
    __slots__ = ("sample_rate", "channels", "bits", "fmt", "data_offset", "frames")


def _check_not_ogg(path: str) -> None:
    if str(path).endswith(".ogg"):
        raise NotImplementedError(f"{path}: .ogg is not supported by the port yet: {OGG_TODO}")


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
    _check_not_ogg(path)
    with open(path, "rb") as fp:
        wi = _parse_header(fp, path)
    return wi.sample_rate, wi.frames, wi.channels


def read(path: str, start: int = 0, stop: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Read frames [start, stop) as float32. Returns (waveform, sample_rate)."""
    _check_not_ogg(path)
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


def write(path: str, waveform: np.ndarray, sample_rate: int) -> None:
    """Write a float32 waveform ((n,) or (n, ch)) as 16-bit PCM WAV."""
    _check_not_ogg(path)
    wav = np.asarray(waveform, dtype=np.float32)
    if wav.ndim == 1:
        wav = wav[:, None]
    frames, ch = wav.shape
    pcm = (np.clip(wav, -1.0, 1.0) * np.float32(32767.0)).astype("<i2")  # truncates
    data_bytes = frames * ch * 2
    header = b"RIFF" + struct.pack("<I", 36 + data_bytes) + b"WAVE"
    header += b"fmt " + struct.pack("<IHHIIHH", 16, 1, ch, sample_rate,
                                    sample_rate * ch * 2, ch * 2, 16)
    header += b"data" + struct.pack("<I", data_bytes)
    Path(path).write_bytes(header + pcm.tobytes())
