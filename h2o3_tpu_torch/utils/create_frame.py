"""h2o.create_frame of the port (h2o3_tpu/utils/create_frame.py; water's
CreateFrame and h2o-py's create_frame): a random frame of mixed column
types for tests and demos. The draws are the JAX package's, one
`np.random.default_rng(seed)` in the same order, so a seed gives the same
frame in both packages."""

from __future__ import annotations

import numpy as np

from h2o3_tpu_torch.core.frame import Frame


def create_frame(rows: int = 10000, cols: int = 10, randomize: bool = True,
                 categorical_fraction: float = 0.2, factors: int = 5,
                 integer_fraction: float = 0.2, binary_fraction: float = 0.1,
                 time_fraction: float = 0.0, string_fraction: float = 0.0,
                 real_range: float = 100.0, integer_range: float = 100.0,
                 missing_fraction: float = 0.01, has_response: bool = False,
                 response_factors: int = 2, seed: int = -1,
                 frame_id: str | None = None) -> Frame:
    rng = np.random.default_rng(seed if seed and seed > 0 else None)
    n_cat = int(cols * categorical_fraction)
    n_int = int(cols * integer_fraction)
    n_bin = int(cols * binary_fraction)
    n_time = int(cols * time_fraction)
    n_str = int(cols * string_fraction)
    n_real = max(0, cols - n_cat - n_int - n_bin - n_time - n_str)
    data = {}
    types = {}
    i = 0

    def miss(col):
        if missing_fraction > 0:
            m = rng.random(rows) < missing_fraction
            if col.dtype == object:
                col[m] = None
            else:
                col = col.astype(np.float64)
                col[m] = np.nan
        return col

    for _ in range(n_real):
        data[f"C{i+1}"] = miss(rng.uniform(-real_range, real_range, rows))
        i += 1
    for _ in range(n_int):
        data[f"C{i+1}"] = miss(rng.integers(
            -int(integer_range), int(integer_range), rows).astype(np.float64))
        i += 1
    for _ in range(n_bin):
        data[f"C{i+1}"] = miss(rng.integers(0, 2, rows).astype(np.float64))
        i += 1
    for _ in range(n_cat):
        lv = np.array([f"c{i}.l{j}" for j in range(factors)], object)
        data[f"C{i+1}"] = miss(lv[rng.integers(0, factors, rows)])
        i += 1
    for _ in range(n_time):
        base = np.datetime64("2020-01-01").astype("datetime64[ms]") \
            .astype(np.int64)
        data[f"C{i+1}"] = miss((base + rng.integers(0, 365 * 86400000, rows))
                               .astype(np.float64))
        types[f"C{i+1}"] = "time"
        i += 1
    for _ in range(n_str):
        words = np.array(["".join(rng.choice(list("abcdefgh"), 8))
                          for _ in range(rows)], object)
        data[f"C{i+1}"] = miss(words)
        types[f"C{i+1}"] = "str"
        i += 1
    if has_response:
        if response_factors > 1:
            lv = np.array([f"resp{j}" for j in range(response_factors)],
                          object)
            data["response"] = lv[rng.integers(0, response_factors, rows)]
        else:
            data["response"] = rng.normal(0, 1, rows)
    return Frame.from_dict(data, key=frame_id, column_types=types)
