"""Points and rectangles.

Mirrors zpix src/image/geometry.zig:2-55 (itself Go's
image.Point/Rectangle): init normalizes so min <= max, ``intersect``
returns None for empty intersections.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Point:
    x: int = 0
    y: int = 0

    def in_rect(self, r: "Rectangle") -> bool:
        return r.min.x <= self.x < r.max.x and r.min.y <= self.y < r.max.y


@dataclass(frozen=True)
class Rectangle:
    min: Point
    max: Point

    @staticmethod
    def init(x0: int, y0: int, x1: int, y1: int) -> "Rectangle":
        if x0 > x1:
            x0, x1 = x1, x0
        if y0 > y1:
            y0, y1 = y1, y0
        return Rectangle(Point(x0, y0), Point(x1, y1))

    @property
    def dx(self) -> int:
        return self.max.x - self.min.x

    @property
    def dy(self) -> int:
        return self.max.y - self.min.y

    def size(self) -> Point:
        return Point(self.dx, self.dy)

    def empty(self) -> bool:
        return self.min.x >= self.max.x or self.min.y >= self.max.y

    def intersect(self, other: "Rectangle"):
        x0 = max(self.min.x, other.min.x)
        y0 = max(self.min.y, other.min.y)
        x1 = min(self.max.x, other.max.x)
        y1 = min(self.max.y, other.max.y)
        r = Rectangle(Point(x0, y0), Point(x1, y1))
        return None if r.empty() else r
