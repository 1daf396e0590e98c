"""Minimal binary-little-endian PLY reader/writer (no plyfile dependency).

Covers what the pipeline needs: a single `vertex` element of float32
properties (reference save_ply/load_ply, scene/gaussian_model.py:309-407,
and the `check/points3d.ply` style input clouds, which may also carry uchar
colors).
"""
from __future__ import annotations

import numpy as np

_PLY_DTYPES = {
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
    "uchar": np.uint8, "uint8": np.uint8, "char": np.int8,
    "short": np.int16, "ushort": np.uint16,
    "int": np.int32, "int32": np.int32, "uint": np.uint32,
}
_PLY_NAMES = {np.dtype(np.float32): "float", np.dtype(np.float64): "double",
              np.dtype(np.uint8): "uchar", np.dtype(np.int32): "int"}


def write_ply(path: str, names: list[str], columns: np.ndarray) -> None:
    """Write [N, len(names)] float32 columns as a binary PLY vertex element."""
    columns = np.ascontiguousarray(columns, dtype=np.float32)
    n = columns.shape[0]
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header", ""]
    rec = np.rec.fromarrays(columns.T, names=",".join(names))
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read the `vertex` element; returns {property_name: [N] array}."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    lines = data[:end].decode("ascii", errors="replace").splitlines()
    fmt = next(l.split()[1] for l in lines if l.startswith("format"))
    counts: list[tuple[str, int]] = []
    props: dict[str, list[tuple[str, np.dtype]]] = {}
    current = None
    for line in lines:
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "element":
            current = tok[1]
            counts.append((current, int(tok[2])))
            props[current] = []
        elif tok[0] == "property" and current is not None:
            if tok[1] == "list":
                raise ValueError("list properties unsupported")
            props[current].append((tok[2], np.dtype(_PLY_DTYPES[tok[1]])))

    if fmt == "ascii":
        body = data[end:].decode("ascii").split()
        out: dict[str, np.ndarray] = {}
        offset = 0
        for elem, n in counts:
            width = len(props[elem])
            vals = np.array(body[offset:offset + n * width], dtype=np.float64)
            vals = vals.reshape(n, width)
            offset += n * width
            if elem == "vertex":
                for i, (name, dt) in enumerate(props[elem]):
                    out[name] = vals[:, i].astype(dt)
        return out

    assert fmt == "binary_little_endian", fmt
    offset = end
    out = {}
    for elem, n in counts:
        dt = np.dtype([(name, d.newbyteorder("<")) for name, d in props[elem]])
        arr = np.frombuffer(data, dtype=dt, count=n, offset=offset)
        offset += dt.itemsize * n
        if elem == "vertex":
            for name, _ in props[elem]:
                out[name] = np.array(arr[name])
    return out
