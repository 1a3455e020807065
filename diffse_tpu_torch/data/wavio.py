"""Minimal RIFF/WAVE reader + writer (numpy only): the port's own copy of
diffse_tpu/data/wavio.py, so that the port imports nothing of the JAX
package.

PCM 16/24/32-bit and IEEE float32 WAV files at any sample rate and channel
count, which covers VoiceBank-DEMAND (16 kHz, 16-bit mono). Like torchaudio,
:func:`read_wav` returns ``[channels, samples]`` float32 in [-1, 1].
"""

from __future__ import annotations

import struct

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file.

    Returns:
        (data, sample_rate) where data is float32 ``[channels, samples]``
        scaled to [-1, 1] (PCM) or passed through (float).
    """
    with open(path, "rb") as f:
        raw = f.read()
    return parse_wav(raw, name=path)


def parse_wav(raw: bytes, name: str = "<bytes>") -> tuple[np.ndarray, int]:
    """Parse in-memory WAV bytes (same contract as :func:`read_wav`)."""
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{name}: not a RIFF/WAVE file")

    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        chunk_id = raw[pos : pos + 4]
        (chunk_size,) = struct.unpack("<I", raw[pos + 4 : pos + 8])
        body = raw[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            data = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned

    if fmt is None or data is None:
        raise ValueError(f"{name}: missing fmt/data chunk")

    audio_format, channels, sample_rate, _byte_rate, _block_align, bits = fmt
    if audio_format == _WAVE_FORMAT_EXTENSIBLE:
        # Sub-format GUID's first two bytes give the actual format tag.
        audio_format = _WAVE_FORMAT_PCM if bits != 32 else _WAVE_FORMAT_IEEE_FLOAT

    if audio_format == _WAVE_FORMAT_PCM and bits == 16:
        x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif audio_format == _WAVE_FORMAT_PCM and bits == 32:
        x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    elif audio_format == _WAVE_FORMAT_PCM and bits == 24:
        b = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT and bits == 32:
        x = np.frombuffer(data, dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"{name}: unsupported WAV format tag={audio_format} bits={bits}")

    x = x.reshape(-1, channels).T  # [channels, samples]
    return np.ascontiguousarray(x), sample_rate


def wav_bytes(data: np.ndarray, sample_rate: int, subtype: str = "pcm16") -> bytes:
    """Serialize audio to in-memory WAV bytes (see :func:`write_wav`)."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[None, :]
    channels, _num_samples = data.shape
    interleaved = data.T.reshape(-1)

    if subtype == "pcm16":
        fmt_tag, bits = _WAVE_FORMAT_PCM, 16
        pcm = np.clip(interleaved, -1.0, 1.0)
        payload = (pcm * 32767.0).round().astype("<i2").tobytes()
    elif subtype == "float32":
        fmt_tag, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
        payload = interleaved.astype("<f4").tobytes()
    else:
        raise ValueError(f"unsupported subtype {subtype}")

    block_align = channels * bits // 8
    byte_rate = sample_rate * block_align
    fmt_chunk = struct.pack("<HHIIHH", fmt_tag, channels, sample_rate, byte_rate, block_align, bits)

    parts = [
        b"RIFF",
        struct.pack("<I", 4 + 8 + len(fmt_chunk) + 8 + len(payload)),
        b"WAVE",
        b"fmt ",
        struct.pack("<I", len(fmt_chunk)),
        fmt_chunk,
        b"data",
        struct.pack("<I", len(payload)),
        payload,
    ]
    return b"".join(parts)


def write_wav(path: str, data: np.ndarray, sample_rate: int, subtype: str = "pcm16") -> None:
    """Write a WAV file.

    Args:
        data: ``[samples]`` or ``[channels, samples]`` float array in [-1, 1].
        subtype: "pcm16" or "float32".
    """
    with open(path, "wb") as f:
        f.write(wav_bytes(data, sample_rate, subtype))
