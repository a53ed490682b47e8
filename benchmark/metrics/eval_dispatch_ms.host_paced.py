"""eval_dispatch_ms.host_paced: `eval_dispatch_ms` (`metrics/eval_dispatch_ms.py`) in the eval
cells whose requests the host's dispatch paces: their host-clock rates and
tails spread from run to run with the host's speed, so they are metrics of
their own with a bound of their own."""
from benchlib import manifest

_base = manifest.reader("eval_dispatch_ms")
SPANS = getattr(_base, "SPANS", ())
FLOPS = getattr(_base, "FLOPS", False)
read = _base.read
