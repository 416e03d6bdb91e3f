"""MEMHD: the port's ``MemhdModel`` of the benchmark's projection and AM,
deployed through ``repro_torch.deploy.registry`` for the route's target,
serving feature rows through the route's call."""
from __future__ import annotations

import inspect

from perfbench import trace


def deploy(cell, inputs, seed: int, root):
    """The program's model of ``inputs``, deployed for the cell's route:
    a callable from a batch of feature rows to the tuple of answers."""
    from repro_torch.core import am as am_lib
    from repro_torch.core.memhd import MemhdModel
    from repro_torch.core.types import EncoderConfig, MemhdConfig
    from repro_torch.deploy import registry

    cfg, route = cell.config, cell.route
    enc = EncoderConfig(kind=cfg["encoder"], features=cfg["features"],
                        dim=cfg["dim"], binarize_query=cfg["binarize_query"])
    amc = MemhdConfig(dim=cfg["dim"], columns=cfg["columns"],
                      classes=cfg["classes"], threshold=cfg["threshold"])
    model = MemhdModel({"projection": inputs.projection},
                       am_lib.make_am_state(inputs.am, inputs.owners,
                                            amc.threshold), enc, amc)
    opts = {}
    for key, value in cell.deploy_opts.items():
        typed = trace.load_module(root, "options", key)
        opts[key] = typed.make(value) if typed else value
    if "seed" in inspect.signature(registry.get_backend(
            route["target"])).parameters:
        opts["seed"] = seed
    artifact = model.deploy(target=route["target"], **opts)
    method, kwargs = getattr(artifact, route["call"]), route.get("kwargs", {})

    def call(x):
        out = method(x, **kwargs)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    return call
