"""Primitive drawing on RGBA images.

Mirrors the reference's Drawer (zpix src/image/draw.zig:10-116):
clear, setPixel, Bresenham line/circle, fillRect.  Colors are RGBA8 tuples
(already 8-bit; the reference converts Color->toRGBA>>8 at the call site).
"""

from __future__ import annotations

from .geometry import Rectangle
from .model import RGBAImage


class Drawer:
    def __init__(self, img: RGBAImage):
        self.img = img

    def clear(self, rgba) -> None:
        self.img.pix[:, :] = rgba

    def set_pixel(self, x: int, y: int, rgba) -> None:
        if 0 <= x < self.img.width and 0 <= y < self.img.height:
            self.img.pix[y, x] = rgba

    def draw_line(self, x0: int, y0: int, x1: int, y1: int, rgba) -> None:
        dx = abs(x1 - x0)
        dy = -abs(y1 - y0)
        sx = 1 if x0 < x1 else -1
        sy = 1 if y0 < y1 else -1
        err = dx + dy
        x, y = x0, y0
        while True:
            self.set_pixel(x, y, rgba)
            if x == x1 and y == y1:
                break
            e2 = 2 * err
            if e2 >= dy:
                if x == x1:
                    break
                err += dy
                x += sx
            if e2 <= dx:
                if y == y1:
                    break
                err += dx
                y += sy

    def fill_rect(self, rect: Rectangle, rgba) -> None:
        x0 = max(rect.min.x, 0)
        y0 = max(rect.min.y, 0)
        x1 = min(rect.max.x, self.img.width)
        y1 = min(rect.max.y, self.img.height)
        if x0 < x1 and y0 < y1:
            self.img.pix[y0:y1, x0:x1] = rgba

    def draw_circle(self, x0: int, y0: int, radius: int, rgba) -> None:
        x, y, err = radius, 0, 0
        while x >= y:
            for px, py in (
                (x0 + x, y0 + y),
                (x0 + y, y0 + x),
                (x0 - y, y0 + x),
                (x0 - x, y0 + y),
                (x0 - x, y0 - y),
                (x0 - y, y0 - x),
                (x0 + y, y0 - x),
                (x0 + x, y0 - y),
            ):
                self.set_pixel(px, py, rgba)
            y += 1
            err += 1 + 2 * y
            if 2 * (err - x) + 1 > 0:
                x -= 1
                err += 1 - 2 * x
