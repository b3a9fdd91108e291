"""Location-score CSV export (copy of ``ransac_tpu.io.export``'s
``write_location_csv``; main_v1.py:286-292)."""

from __future__ import annotations

import csv
from typing import Iterable, Sequence

# Header exactly as the reference writes it (main_v1.py:290) — the names
# 'min_score'/'max_score' are historical: the columns hold (err1, err2) and
# Z,X,Y hold easting, northing, elevation.
LOCATION_HEADER = ["location_id", "min_score", "max_score", "grid_code",
                   "Z", "X", "Y"]


def write_location_csv(path: str, rows: Iterable[Sequence]) -> None:
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(LOCATION_HEADER)
        for r in rows:
            w.writerow(r)
