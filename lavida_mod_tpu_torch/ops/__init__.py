"""Tensor ops and kernel wrappers.  Import the submodules directly; this
package imports nothing itself, so loading one op never loads the rest."""
