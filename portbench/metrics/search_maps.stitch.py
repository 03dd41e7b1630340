"""The SAD maps the port's search init scored a panorama: the tracer's
counter ``search_maps`` (19 a searched direction: the zero offset and the
search box's 18), over one call of the cell's driver made under
``trace.recording()`` after the window, a replay of the program the
window used.  A program counts on every replay what its capture counted,
so the number shows that every direction of every pair searched.

``portbench/spans.py`` keeps no counter but ``host_syncs``, so this
reader makes the call itself, on the first input set of the pool the run
makes from its seed.  A port whose tracer has no such counter reads
None."""

import importlib


def read(run):
    try:
        from panorama_opticalflow_tpu_torch.utils import trace
    except ImportError:
        return None
    if not hasattr(trace.Recording(), "search_maps"):
        return None
    import torch

    from panorama_opticalflow_tpu_torch import StitchConfig

    driver = importlib.import_module(
        f"portbench.drivers.{run.traffic['driver']}")
    item = driver.make_pool(run.config, dict(run.traffic, pool=1), run.seed,
                            run.device)[0]
    with trace.recording() as rec:
        driver.stitch(item, StitchConfig(flow_alg=run.config["flow_alg"]),
                      run.device)
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
    return rec.search_maps / driver.panoramas(item)
