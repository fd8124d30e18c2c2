"""SSD1306 OLED display sink over Linux i2c-dev.

A copy of `pi_sph_fluid_tpu/io/ssd1306.py:24-69` for the port (framework-free host code).

The reference blits through the external lexus2k/ssd1306 C library
(`pi_sph_fluid.c:8,468-469`).  This sink speaks the SSD1306 protocol
directly over /dev/i2c-N (ioctl I2C_SLAVE + raw writes), so the framework
drives the same 128x64 OLED with no external driver.  The framebuffer
format is already the panel's native page-packed layout
(render/metaballs.py), so a frame is one control byte + 1024 data bytes.

Untestable without the panel; constructed lazily and raising cleanly when
the bus is absent.  Init sequence follows the SSD1306 datasheet's charge-
pump application note (the same registers every driver programs).
"""

from __future__ import annotations

import fcntl
import os

import numpy as np

__all__ = ["SSD1306Sink"]

I2C_SLAVE = 0x0703  # linux/i2c-dev.h

_INIT_SEQUENCE = bytes([
    0xAE,        # display off
    0xD5, 0x80,  # clock divide
    0xA8, 0x3F,  # multiplex 64
    0xD3, 0x00,  # display offset
    0x40,        # start line 0
    0x8D, 0x14,  # charge pump on
    0x20, 0x00,  # horizontal addressing mode
    0xA1,        # segment remap
    0xC8,        # COM scan dec
    0xDA, 0x12,  # COM pins
    0x81, 0xCF,  # contrast
    0xD9, 0xF1,  # precharge
    0xDB, 0x40,  # VCOM detect
    0xA4,        # resume from RAM
    0xA6,        # normal (non-inverted)
    0xAF,        # display on
])


class SSD1306Sink:
    """Display sink pushing page-packed framebuffers to a real SSD1306."""

    def __init__(self, bus: int = 1, address: int = 0x3C):
        self.fd = os.open(f"/dev/i2c-{bus}", os.O_RDWR)
        fcntl.ioctl(self.fd, I2C_SLAVE, address)
        self._cmd(_INIT_SEQUENCE)

    def _cmd(self, data: bytes) -> None:
        # control byte 0x00: command stream
        os.write(self.fd, b"\x00" + data)

    def push(self, framebuffer: np.ndarray) -> None:
        fb = np.asarray(framebuffer, np.uint8)
        # reset the addressing window to the full panel
        self._cmd(bytes([0x21, 0, 127, 0x22, 0, 7]))
        # control byte 0x40: data stream; one write blits the whole frame
        os.write(self.fd, b"\x40" + fb.tobytes())

    def close(self) -> None:
        try:
            self._cmd(bytes([0xAE]))
        finally:
            os.close(self.fd)
