"""The 95th percentile, over every request of the window, of the time from
its sending to its image in host memory, in ms. A per-layer metric: its runs
spread by ~10% between runs of one seed (8-11% over two sets of six runs,
two host states), too wide for a bound, so `render_fps` carries the cells."""
import statistics


def read(run):
    if run.kind != "serve" or len(run.latencies_s) < 20:
        return None
    return 1e3 * statistics.quantiles(run.latencies_s, n=100)[94]
