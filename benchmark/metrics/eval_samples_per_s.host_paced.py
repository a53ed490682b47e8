"""eval_samples_per_s.host_paced: `eval_samples_per_s` (`metrics/eval_samples_per_s.py`) in the eval cells
whose requests the host's dispatch paces: their host-clock rates and tails
spread from run to run with the host's speed, so they are metrics of their
own with a bound of their own."""
from benchlib import manifest

_base = manifest.reader("eval_samples_per_s")
SPANS = getattr(_base, "SPANS", ())
FLOPS = getattr(_base, "FLOPS", False)
read = _base.read
