"""The serving layer of the port (lavida_mod_tpu/serve): the controller,
the model worker and its micro-batcher, the browser page and the
terminal chat."""

from .controller import Controller  # noqa: F401
from .worker import ModelWorker  # noqa: F401
