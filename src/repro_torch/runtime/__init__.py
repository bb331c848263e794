"""Runtime supervision — the port's own copies of ``repro/runtime/``
(``fault_tolerance``, ``elastic``, ``campaign``)."""
