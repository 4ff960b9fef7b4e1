"""The configurations' families: how each is built in the port, and the
benchmark's own view of it (reference forward, fan-in, work). A family
module is found by the ``family`` key of a configuration file."""


def preset_config(conf):
    """The port's config of a configuration file: its ``preset`` called
    with every size of its ``model`` (lists as the tuples the presets
    take)."""
    from d3d_tpu_torch.models import presets

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    return getattr(presets, conf["preset"])(
        **{k: tup(v) for k, v in conf["model"].items()})
