"""Attribute-accessible dict (the port's copy of ``d3d_tpu.utils.edict``):
no recursive conversion magic, just attribute <-> item aliasing."""


class EDict(dict):
    """dict with attribute access: ``d.key`` == ``d['key']``."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def copy(self):
        return EDict(self)
