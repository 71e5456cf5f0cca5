"""The program's own kernel launches (`csgn_tpu_torch.ops._build.LAUNCHES`)
over the window, per request; the counters of launch paths that are also
counted under their wrapper's own counter are left out."""

ALSO_COUNTED = ("philox_tile", "philox_tile_4byte", "philox_column", "benes_lanes",
                "benes_wide")


def read(run):
    if not run.requests:
        return None
    return sum(v for k, v in run.launches.items() if k not in ALSO_COUNTED) / run.requests
