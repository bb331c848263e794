"""Runtime supervision — port of the part of ``repro/runtime/`` that training uses."""
