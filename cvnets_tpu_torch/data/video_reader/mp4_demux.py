"""Pure-Python ISO BMFF (MP4/MOV) demuxer (a copy of
cvnets_tpu/data/video_reader/mp4_demux.py, so the port imports nothing of the
JAX package).

It walks the box tree (moov → trak → mdia → minf → stbl) and rebuilds each
sample's byte range from the sample tables (stsd/stts/stsc/stsz/stco|co64),
which covers the codecs that decode without a codec library:

* video: MJPEG tracks (fourcc ``jpeg``/``mjpa``/``mjpb``): every sample is a
  whole JPEG, decoded by Pillow;
* audio: uncompressed PCM (``sowt``/``twos``/``lpcm``/``raw ``).

Compressed codecs (avc1/hevc/mp4a/...) are demuxed but not decoded; the
reader names the codec it cannot decode.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"udta"}


def _iter_boxes(data: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        size, btype = struct.unpack(">I4s", data[pos: pos + 8])
        hdr = 8
        if size == 1:
            size = struct.unpack(">Q", data[pos + 8: pos + 16])[0]
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            return
        yield btype, pos + hdr, pos + size
        pos += size


def _find_boxes(data: bytes, start: int, end: int, path: Tuple[bytes, ...]):
    """All (start, end) payload ranges at the given box path."""
    if not path:
        return [(start, end)]
    out = []
    for btype, s, e in _iter_boxes(data, start, end):
        if btype == path[0]:
            out.extend(_find_boxes(data, s, e, path[1:]))
    return out


def _u32s(payload: bytes, offset: int, n: int) -> List[int]:
    return list(struct.unpack(f">{n}I", payload[offset: offset + 4 * n]))


def _parse_stbl(data: bytes, s: int, e: int) -> Optional[Dict]:
    boxes = {btype: (bs, be) for btype, bs, be in _iter_boxes(data, s, e)}
    if b"stsd" not in boxes or b"stsz" not in boxes:
        return None

    # stsd: first sample-description fourcc (+ audio fields when applicable)
    ds, de = boxes[b"stsd"]
    entry = data[ds + 8: de]  # skip version/flags + entry_count
    codec = entry[4:8].decode("latin1") if len(entry) >= 8 else ""
    audio_rate = audio_channels = audio_bits = None
    if len(entry) >= 36:
        # sound sample description v0: channels@16, bits@18, rate@24 (16.16)
        audio_channels = struct.unpack(">H", entry[24:26])[0]
        audio_bits = struct.unpack(">H", entry[26:28])[0]
        audio_rate = struct.unpack(">I", entry[32:36])[0] >> 16

    # stsz
    zs, ze = boxes[b"stsz"]
    sample_size, count = struct.unpack(">II", data[zs + 4: zs + 12])
    if sample_size:
        sizes = [sample_size] * count
    else:
        sizes = _u32s(data, zs + 12, count)

    # stco / co64
    if b"stco" in boxes:
        cs, ce = boxes[b"stco"]
        n_chunks = struct.unpack(">I", data[cs + 4: cs + 8])[0]
        chunk_offsets = _u32s(data, cs + 8, n_chunks)
    elif b"co64" in boxes:
        cs, ce = boxes[b"co64"]
        n_chunks = struct.unpack(">I", data[cs + 4: cs + 8])[0]
        chunk_offsets = list(struct.unpack(
            f">{n_chunks}Q", data[cs + 8: cs + 8 + 8 * n_chunks]))
    else:
        return None

    # stsc: (first_chunk, samples_per_chunk, desc_idx) runs
    ss, se = boxes[b"stsc"]
    n_runs = struct.unpack(">I", data[ss + 4: ss + 8])[0]
    runs = [struct.unpack(">III", data[ss + 8 + 12 * i: ss + 20 + 12 * i])
            for i in range(n_runs)]

    # expand to absolute (offset, size) per sample
    samples: List[Tuple[int, int]] = []
    si = 0
    for ri, (first, per_chunk, _d) in enumerate(runs):
        last = (runs[ri + 1][0] - 1 if ri + 1 < len(runs)
                else len(chunk_offsets))
        for ci in range(first - 1, last):
            off = chunk_offsets[ci]
            for _ in range(per_chunk):
                if si >= len(sizes):
                    break
                samples.append((off, sizes[si]))
                off += sizes[si]
                si += 1

    # stts: total duration in timescale units per sample (optional)
    durations: List[int] = []
    if b"stts" in boxes:
        ts, te = boxes[b"stts"]
        n = struct.unpack(">I", data[ts + 4: ts + 8])[0]
        for i in range(n):
            cnt, dur = struct.unpack(">II", data[ts + 8 + 8 * i:
                                                 ts + 16 + 8 * i])
            durations.extend([dur] * cnt)

    return {"codec": codec, "samples": samples, "durations": durations,
            "audio_rate": audio_rate, "audio_channels": audio_channels,
            "audio_bits": audio_bits}


def parse_mp4(data: bytes) -> List[Dict]:
    """Parse the container into per-track dicts: {"handler", "codec",
    "timescale", "samples" [(abs_offset, size)], "durations",
    audio_rate/channels/bits}."""
    tracks = []
    for ts, te in _find_boxes(data, 0, len(data), (b"moov", b"trak")):
        handler = None
        timescale = None
        for ms, me in _find_boxes(data, ts, te, (b"mdia",)):
            for btype, bs, be in _iter_boxes(data, ms, me):
                if btype == b"mdhd":
                    version = data[bs]
                    if version == 1:
                        timescale = struct.unpack(">I", data[bs + 20: bs + 24])[0]
                    else:
                        timescale = struct.unpack(">I", data[bs + 12: bs + 16])[0]
                elif btype == b"hdlr":
                    handler = data[bs + 8: bs + 12].decode("latin1")
            for s, e in _find_boxes(data, ms, me, (b"minf", b"stbl")):
                info = _parse_stbl(data, s, e)
                if info is not None:
                    info["handler"] = handler
                    info["timescale"] = timescale
                    tracks.append(info)
    return tracks


def decode_mjpeg_track(data: bytes, track: Dict) -> List:
    """Decode every sample of an MJPEG track to PIL images."""
    import io

    from PIL import Image

    frames = []
    for off, size in track["samples"]:
        frames.append(Image.open(io.BytesIO(data[off: off + size]))
                      .convert("RGB"))
    return frames


def decode_pcm_track(data: bytes, track: Dict):
    """(samples, channels) float32 in [-1, 1] from a raw-PCM track."""
    import numpy as np

    codec = track["codec"]
    raw = b"".join(data[o: o + s] for o, s in track["samples"])
    bits = track.get("audio_bits") or 16
    if bits == 16:
        dt = "<i2" if codec in ("sowt", "lpcm", "raw ") else ">i2"
        arr = np.frombuffer(raw, dt).astype(np.float32) / 32768.0
    elif bits == 8:
        arr = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        return None
    ch = max(1, track.get("audio_channels") or 1)
    n = (arr.shape[0] // ch) * ch
    return arr[:n].reshape(-1, ch)
