"""Tensor ops and kernel wrappers.  Import the submodules directly; this
package imports nothing of its own, so loading one op never loads the rest.

It does settle one thing at import: the first `torch.exp` of a CPU process,
when two intra-op threads make it at once, can take another path than every
later call, and its results then differ by up to 1e-4 of values below 1
(about one fresh process in five under load, on the plain attention
versions' shapes).  One small single-threaded call here makes the first
parallel call like every later one, so the plain versions give the same
numbers in every process."""

import torch

torch.exp(torch.zeros(8))
