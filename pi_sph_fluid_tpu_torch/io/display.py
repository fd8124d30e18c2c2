"""Display sinks — the output side of the host I/O shell.

A copy of `pi_sph_fluid_tpu/io/display.py:22-271` for the port (framework-free host code).

The reference blits the shared 1-bpp framebuffer to an SSD1306 OLED (or an
SDL window) from a pthread in a busy loop (`pi_sph_fluid.c:466-470`).  Here a
sink is a consumer of page-packed framebuffers produced on device; the run
loop pushes at most one frame per dispatch and sinks drop frames rather than
block (same tearing-tolerant contract as the reference, made explicit).
"""

from __future__ import annotations

import queue
import sys
import threading

import numpy as np

__all__ = ["NullSink", "TerminalSink", "FileSink", "PngSink", "GifSink",
           "AsyncSink"]


class NullSink:
    """Benchmark mode: frames are produced and dropped."""

    def push(self, framebuffer: np.ndarray) -> None:
        pass

    def close(self) -> None:
        pass


class TerminalSink:
    """Renders the 128x64 framebuffer as unicode half-blocks (64x32 chars) —
    the desktop_sph_fluid SDL window equivalent for a terminal."""

    def __init__(self, rows: int = 64, cols: int = 128, stream=None):
        self.rows, self.cols = rows, cols
        self.stream = stream or sys.stdout
        self._first = True

    def push(self, framebuffer: np.ndarray) -> None:
        from .native import blit_halfblocks

        frame = blit_halfblocks(np.asarray(framebuffer, np.uint8), self.rows, self.cols)
        if not self._first:
            self.stream.write(f"\x1b[{self.rows // 2}A")  # cursor up, repaint in place
        self._first = False
        self.stream.write(frame)
        self.stream.flush()

    def close(self) -> None:
        pass


class FileSink:
    """Appends raw packed framebuffers to a file (replayable / diffable)."""

    def __init__(self, path: str):
        self.f = open(path, "ab")

    def push(self, framebuffer: np.ndarray) -> None:
        self.f.write(np.asarray(framebuffer, np.uint8).tobytes())

    def close(self) -> None:
        self.f.close()


class PngSink:
    """Writes each frame as an upscaled PNG (frame_000123.png) — the desktop
    analog of the reference's SDL window target (`Makefile:18-23`): a
    graphical view without any display hardware.  Pure-stdlib encoder
    (zlib + PNG chunks), no imaging dependency.
    """

    def __init__(self, path_prefix: str, rows: int = 64, cols: int = 128,
                 scale: int = 4):
        self.prefix = path_prefix
        self.rows, self.cols, self.scale = rows, cols, scale
        self.count = 0

    def _encode(self, img: np.ndarray) -> bytes:
        import struct
        import zlib

        h, w = img.shape
        raw = b"".join(b"\x00" + row.tobytes() for row in img)
        def chunk(tag, data):
            c = tag + data
            return struct.pack(">I", len(data)) + c + struct.pack(
                ">I", zlib.crc32(c) & 0xFFFFFFFF)
        ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # 8-bit grayscale
        return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))

    def push(self, framebuffer: np.ndarray) -> None:
        from ..render.metaballs import unpack_framebuffer

        lit = unpack_framebuffer(framebuffer, self.rows, self.cols)
        img = np.where(lit, np.uint8(255), np.uint8(16))
        img = np.repeat(np.repeat(img, self.scale, 0), self.scale, 1)
        with open(f"{self.prefix}_{self.count:06d}.png", "wb") as f:
            f.write(self._encode(img))
        self.count += 1

    def close(self) -> None:
        pass


class GifSink:
    """Records the run as one looping animated GIF — the shareable-demo
    artifact (the reference's README leads with a photo of the device;
    ``--display gif:out.gif`` is the software equivalent for a framework
    user).  Pure-stdlib GIF89a encoder (2-color palette + LZW), no imaging
    dependency.

    ``push`` only appends the packed 1-bpp frame (~1 KB) so the sim loop is
    never blocked; the encode happens in ``close``.  Runs longer than
    ``max_frames`` frames are adaptively decimated: the retained set is
    thinned 2x and the per-frame delay doubled, so any run length yields a
    bounded, uniformly-sampled loop.
    """

    def __init__(self, path: str, rows: int = 64, cols: int = 128,
                 scale: int = 4, fps: float = 30.0, max_frames: int = 1800):
        assert max_frames >= 2
        self.path = path
        self.rows, self.cols, self.scale = rows, cols, scale
        self.base_delay = max(2, round(100.0 / fps))  # 1/100 s GIF units
        self.max_frames = max_frames
        self.stride = 1      # record every stride-th pushed frame
        self._skip = 0
        self.frames: list[bytes] = []

    def push(self, framebuffer: np.ndarray) -> None:
        if self._skip:
            self._skip -= 1
            return
        self._skip = self.stride - 1
        self.frames.append(np.asarray(framebuffer, np.uint8).tobytes())
        if len(self.frames) >= self.max_frames:
            self.frames = self.frames[::2]
            self.stride *= 2

    @staticmethod
    def _lzw(data: bytes, mcs: int) -> bytes:
        """GIF-variant LZW: variable 3..12-bit codes, LSB-first packing,
        dictionary reset at 4096."""
        clear = 1 << mcs
        eoi = clear + 1
        out = bytearray()
        acc = 0
        nbits = 0

        def emit(code: int, width: int) -> None:
            nonlocal acc, nbits
            acc |= code << nbits
            nbits += width
            while nbits >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nbits -= 8

        width = mcs + 1
        table: dict[int, int] = {}
        next_code = eoi + 1
        emit(clear, width)
        prefix = data[0]
        for c in data[1:]:
            key = (prefix << 8) | c
            got = table.get(key)
            if got is not None:
                prefix = got
                continue
            emit(prefix, width)
            table[key] = next_code
            next_code += 1
            if next_code == (1 << width) + 1 and width < 12:
                width += 1
            if next_code == 4096:
                emit(clear, width)
                table.clear()
                next_code = eoi + 1
                width = mcs + 1
            prefix = c
        emit(prefix, width)
        # end-of-stream width edge case: decoders create one table entry per
        # data code read, so after consuming the final code (which adds no
        # encoder-side entry) a decoder whose table lands exactly on 2^width
        # grows its read width before fetching EOI — emit EOI at the grown
        # width to match (all-same-pixel frames hit this; random ones don't)
        if next_code == (1 << width) and width < 12:
            width += 1
        emit(eoi, width)
        if nbits:
            out.append(acc & 0xFF)
        return bytes(out)

    def encode(self) -> bytes:
        """The complete GIF89a byte stream for the recorded frames."""
        import struct

        from ..render.metaballs import unpack_framebuffer

        w, h = self.cols * self.scale, self.rows * self.scale
        delay = self.base_delay * self.stride
        parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF0, 0, 0),
                 bytes([12, 14, 22, 160, 210, 255]),          # dark, lit (web palette)
                 b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]  # loop forever
        for fb in self.frames:
            lit = unpack_framebuffer(np.frombuffer(fb, np.uint8),
                                     self.rows, self.cols)
            img = np.repeat(np.repeat(lit.astype(np.uint8), self.scale, 0),
                            self.scale, 1)
            parts.append(b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00")
            parts.append(b"\x2c" + struct.pack("<HHHH", 0, 0, w, h) + b"\x00")
            lzw = self._lzw(img.tobytes(), 2)
            parts.append(b"\x02")
            for off in range(0, len(lzw), 255):
                blk = lzw[off:off + 255]
                parts.append(bytes([len(blk)]) + blk)
            parts.append(b"\x00")
        parts.append(b"\x3b")
        return b"".join(parts)

    def close(self) -> None:
        if not self.frames:
            return
        with open(self.path, "wb") as f:
            f.write(self.encode())
        print(f"wrote {self.path}: {len(self.frames)} frames "
              f"({self.cols * self.scale}x{self.rows * self.scale})", flush=True)


class AsyncSink:
    """Wraps any sink with the reference's thread decoupling
    (`pi_sph_fluid.c:466-470`): the sim loop never blocks on display I/O.
    Frames are handed off through a depth-1 queue; if the consumer is busy,
    the old frame is dropped (the reference's tearing, made a clean drop)."""

    def __init__(self, inner):
        self.inner = inner
        self.q: queue.Queue = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                frame = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            self.inner.push(frame)

    def push(self, framebuffer: np.ndarray) -> None:
        try:
            self.q.put_nowait(framebuffer)
        except queue.Full:
            try:  # replace the stale frame
                self.q.get_nowait()
            except queue.Empty:
                pass
            try:
                self.q.put_nowait(framebuffer)
            except queue.Full:
                pass

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1.0)
        self.inner.close()
