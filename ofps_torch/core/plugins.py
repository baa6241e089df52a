"""External plugin discovery (port of ``ofps_tpu.core.plugins``).

Third-party modules register their components through the same
``register`` decorators the built-ins use, and are found by importing every
module named in the ``OFPS_TORCH_PLUGINS`` environment variable
(comma-separated module paths).  The port reads its own variable: a module
named in ``OFPS_TPU_PLUGINS`` registers into the JAX package's registries.

A plugin module does::

    from ofps_torch.estimators.base import register, EstimatorInstance

    @register("my_estimator")
    def make_my_estimator(**kwargs): ...

and ``create_estimator("my_estimator")`` finds it once its module is named
in ``OFPS_TORCH_PLUGINS``.
"""

from __future__ import annotations

import importlib
import logging
import os

ENV = "OFPS_TORCH_PLUGINS"
_loaded = set()


def load_external_plugins() -> None:
    """Import every module named in ``OFPS_TORCH_PLUGINS`` once; a module
    that fails to import is logged and skipped."""
    spec = os.environ.get(ENV, "")
    for mod in filter(None, (m.strip() for m in spec.split(","))):
        if mod in _loaded:
            continue
        _loaded.add(mod)
        try:
            importlib.import_module(mod)
        except Exception:  # a broken plugin must not take down the host app
            logging.getLogger(__name__).exception("failed to load plugin module %r", mod)
