"""Geoshape attribute type + geo predicates.

(reference: titan-core core/attribute/Geoshape.java:672 — point / circle /
box shapes with haversine distance, within/intersect/disjoint relations, a
compact custom serializer, and the ``Geo`` predicate enum used in ``has()``
conditions and mixed-index queries.)
"""

from __future__ import annotations

import math
from typing import Optional

EARTH_RADIUS_KM = 6371.0


class Geoshape:
    """Immutable geo shape: POINT, CIRCLE (center + radius km) or BOX."""

    POINT, CIRCLE, BOX = "point", "circle", "box"

    __slots__ = ("kind", "coords", "radius")

    def __init__(self, kind: str, coords: tuple, radius: float = 0.0):
        self.kind = kind
        self.coords = coords          # ((lat, lon), ...) 1 for point/circle, 2 for box
        self.radius = radius          # km, circles only
        for lat, lon in coords:
            if not (-90.0 <= lat <= 90.0 and -180.0 <= lon <= 180.0):
                raise ValueError(f"illegal (lat, lon): ({lat}, {lon})")

    # -- constructors --------------------------------------------------------

    @staticmethod
    def point(lat: float, lon: float) -> "Geoshape":
        return Geoshape(Geoshape.POINT, ((float(lat), float(lon)),))

    @staticmethod
    def circle(lat: float, lon: float, radius_km: float) -> "Geoshape":
        if radius_km <= 0:
            raise ValueError("radius must be positive")
        return Geoshape(Geoshape.CIRCLE, ((float(lat), float(lon)),),
                        float(radius_km))

    @staticmethod
    def box(sw_lat: float, sw_lon: float, ne_lat: float,
            ne_lon: float) -> "Geoshape":
        if sw_lat > ne_lat or sw_lon > ne_lon:
            raise ValueError("box corners must be (SW, NE)")
        return Geoshape(Geoshape.BOX, ((float(sw_lat), float(sw_lon)),
                                       (float(ne_lat), float(ne_lon))))

    # -- accessors -----------------------------------------------------------

    @property
    def lat(self) -> float:
        return self.coords[0][0]

    @property
    def lon(self) -> float:
        return self.coords[0][1]

    def center(self) -> tuple[float, float]:
        if self.kind == Geoshape.BOX:
            (a, b), (c, d) = self.coords
            return ((a + c) / 2.0, (b + d) / 2.0)
        return self.coords[0]

    # -- geometry ------------------------------------------------------------

    @staticmethod
    def distance_km(a: tuple[float, float], b: tuple[float, float]) -> float:
        """Haversine great-circle distance."""
        la1, lo1 = map(math.radians, a)
        la2, lo2 = map(math.radians, b)
        h = (math.sin((la2 - la1) / 2) ** 2 +
             math.cos(la1) * math.cos(la2) * math.sin((lo2 - lo1) / 2) ** 2)
        return 2 * EARTH_RADIUS_KM * math.asin(min(1.0, math.sqrt(h)))

    def _contains_point(self, p: tuple[float, float]) -> bool:
        if self.kind == Geoshape.POINT:
            return self.coords[0] == p
        if self.kind == Geoshape.CIRCLE:
            return self.distance_km(self.coords[0], p) <= self.radius
        (sw, ne) = self.coords
        return sw[0] <= p[0] <= ne[0] and sw[1] <= p[1] <= ne[1]

    def within(self, outer: "Geoshape") -> bool:
        """Is this shape entirely inside ``outer``? (points fully supported;
        area-in-area approximated by corner/center containment, matching the
        reference's point-in-shape primary use)"""
        if self.kind == Geoshape.POINT:
            return outer._contains_point(self.coords[0])
        if self.kind == Geoshape.BOX:
            (sw, ne) = self.coords
            return outer._contains_point(sw) and outer._contains_point(ne)
        # circle in shape: center inside with radius margin
        if outer.kind == Geoshape.CIRCLE:
            return (self.distance_km(self.coords[0], outer.coords[0]) +
                    self.radius) <= outer.radius
        return outer._contains_point(self.coords[0])

    def intersect(self, other: "Geoshape") -> bool:
        if self.kind == Geoshape.POINT:
            return other._contains_point(self.coords[0])
        if other.kind == Geoshape.POINT:
            return self._contains_point(other.coords[0])
        if self.kind == Geoshape.CIRCLE and other.kind == Geoshape.CIRCLE:
            return self.distance_km(self.coords[0], other.coords[0]) <= \
                self.radius + other.radius
        if self.kind == Geoshape.BOX and other.kind == Geoshape.BOX:
            (asw, ane), (bsw, bne) = self.coords, other.coords
            return not (ane[0] < bsw[0] or bne[0] < asw[0] or
                        ane[1] < bsw[1] or bne[1] < asw[1])
        # box vs circle: nearest point on box to circle center
        box, circ = (self, other) if self.kind == Geoshape.BOX else (other, self)
        (sw, ne) = box.coords
        c = circ.coords[0]
        nearest = (min(max(c[0], sw[0]), ne[0]), min(max(c[1], sw[1]), ne[1]))
        return self.distance_km(c, nearest) <= circ.radius

    def disjoint(self, other: "Geoshape") -> bool:
        return not self.intersect(other)

    # -- equality / repr -----------------------------------------------------

    def __eq__(self, other):
        return (isinstance(other, Geoshape) and self.kind == other.kind and
                self.coords == other.coords and self.radius == other.radius)

    def __hash__(self):
        return hash((self.kind, self.coords, self.radius))

    def __repr__(self):
        if self.kind == Geoshape.POINT:
            return f"point[{self.lat},{self.lon}]"
        if self.kind == Geoshape.CIRCLE:
            return f"circle[{self.lat},{self.lon}:{self.radius}]"
        (sw, ne) = self.coords
        return f"box[{sw[0]},{sw[1]},{ne[0]},{ne[1]}]"

    # -- codec hooks (registered with the attribute serializer) --------------

    def to_floats(self) -> list[float]:
        kind_code = {self.POINT: 0.0, self.CIRCLE: 1.0, self.BOX: 2.0}[self.kind]
        flat = [kind_code]
        for lat, lon in self.coords:
            flat += [lat, lon]
        if self.kind == self.CIRCLE:
            flat.append(self.radius)
        return flat

    @staticmethod
    def from_floats(flat: list[float]) -> "Geoshape":
        kind = [Geoshape.POINT, Geoshape.CIRCLE, Geoshape.BOX][int(flat[0])]
        if kind == Geoshape.POINT:
            return Geoshape.point(flat[1], flat[2])
        if kind == Geoshape.CIRCLE:
            return Geoshape.circle(flat[1], flat[2], flat[3])
        return Geoshape.box(flat[1], flat[2], flat[3], flat[4])
