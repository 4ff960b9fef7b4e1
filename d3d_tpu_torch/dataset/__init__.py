"""Dataset loaders (port of ``d3d_tpu.dataset``).

Submodules are imported lazily by the loaders themselves; importing this
package is cheap.
"""

from . import base, zip  # noqa: F401
