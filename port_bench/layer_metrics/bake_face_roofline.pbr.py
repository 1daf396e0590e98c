"""A bake face's share of its roofline: the least time of a face's work
(`counts/bake.py`: the posed rows read once, the blend of its tile lists as
kernel C's count, from the plain reference's lists of the sampled cells;
their median) over the measured seconds per face (the window's
`mgh.pbr.bake` seconds over the faces `COUNTERS["mgh.pbr.faces"]` counts,
the traced stretch left out). None where the program keeps no such
counters."""


def read(run):
    if run.kind != "train" or not run.extra.get("face_s"):
        return None
    return 100.0 * run.extra["face_least_s"] / run.extra["face_s"]
