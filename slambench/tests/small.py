"""A cell of the benchmark at a size a CPU test can hold: a 160x120 camera,
2 levels x 128 features, 512 map points, a coarse room, chunks of 4, two
streams.  The lap keeps its length, so that a frame moves as far as at
the cell's own size."""

from slambench import harness

SPEC = {"end_to_end": [{"name": "tracked_fps", "unit": "frames/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": []}


def small(name: str):
    """(workload, config) of cell ``name`` cut to the small size."""
    w = harness.load_json("workloads", name)
    c = harness.load_json("configs", w["config"])
    c["camera"] = dict(c["camera"], fx=130.0, fy=130.0, cx=79.5, cy=59.5, width=160,
                       height=120)
    c["slam"]["frontend"].update(height=120, width=160, num_levels=2, features_per_level=128)
    c["slam"]["vo"]["max_map_points"] = 512
    w["scene"].update(tex_res=64, octaves=2, clutter=4)
    w["photometric"]["supersample"] = 1
    w["chunk"] = 4
    w["streams"] = 2
    w["check"]["chunks"] = 2
    return w, c


def run_small(name: str, seconds: float = 1.0, seed: int = 3000000001, control=None):
    w, c = small(name)
    return harness.run_cell(name, seed, seconds, False, device="cpu", workload=w, config=c,
                            spec=SPEC, control=control)
