"""PNG read/write with the standard library (zlib + struct) and numpy.

Twin of ti_raytrace_tpu/io/image.py without PIL: `read_image` decodes
8-bit, non-interlaced RGB/RGBA PNGs (all five row filters) and returns
exactly what PIL's `convert("RGB")` / 255 gives (alpha dropped);
`write_png` encodes 8-bit RGB with filter 0.
"""

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # PNG colour type (RGB, RGBA) -> samples per pixel


def _unfilter(ftype: int, line: bytes, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Reconstruct one scanline (PNG spec section 9.2)."""
    x = np.frombuffer(line, np.uint8)
    if ftype == 0:
        return x.copy()
    if ftype == 1:  # Sub: running sum per channel, mod 256
        s = np.cumsum(x.reshape(-1, bpp).astype(np.int64), axis=0)
        return (s & 255).astype(np.uint8).reshape(-1)
    if ftype == 2:  # Up
        return x + prior
    if ftype not in (3, 4):
        raise ValueError(f"bad PNG filter type {ftype}")
    cur = bytearray(line)
    up = prior.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:  # Average
            pred = (a + b) >> 1
        else:  # Paeth
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 255
    return np.frombuffer(bytes(cur), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W, C) with C in {3, 4}."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {colour}, "
            f"interlace {interlace}): only 8-bit non-interlaced RGB/RGBA"
        )
    bpp = _CHANNELS[colour]
    raw = zlib.decompress(b"".join(idat))
    stride = w * bpp
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        row = raw[y * (stride + 1):(y + 1) * (stride + 1)]
        prior = out[y] = _unfilter(row[0], row[1:], prior, bpp)
    return out.reshape(h, w, bpp)


def read_image(path: str) -> np.ndarray:
    """Load an image as float32 RGB in [0,1], shape (H, W, 3), row 0 = top."""
    with open(path, "rb") as f:
        px = decode_png(f.read())
    return px[:, :, :3].astype(np.float32) / 255.0


def encode_png(rgb: np.ndarray) -> bytes:
    """uint8 (H, W, 3) -> PNG bytes (filter 0 on every row)."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(ctype, body):
        crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)

    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Save a float [0,1] RGB array (H, W, 3), row 0 = top, to PNG."""
    arr = np.clip(np.asarray(img), 0.0, 1.0)
    rgb = np.ascontiguousarray((arr * 255.0 + 0.5).astype(np.uint8))
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def film_to_image(film_xy: np.ndarray) -> np.ndarray:
    """Film layout (W, H, 3) indexed [x, y], y=0 at the bottom -> a
    top-row-first (H, W, 3) image."""
    return np.transpose(np.asarray(film_xy), (1, 0, 2))[::-1]
