"""Control plane: lease-based provisioning over MIG devices; the port's
copy of ``repro.control``.

* :mod:`repro_torch.control.plane` — :class:`ControlPlane` (``provision`` /
  ``status`` / ``release`` / ``extend_lease`` / ``heartbeat`` +
  deterministic ledger replay) and the :class:`Lease` contract.
* ``python -m repro_torch.control`` — the operator CLI persisting plane state
  as a JSON operation ledger (:mod:`repro_torch.control.__main__`).
"""

from repro_torch.control.plane import DEFAULT_LEASE_S, ControlPlane, Lease

__all__ = ["DEFAULT_LEASE_S", "ControlPlane", "Lease"]
