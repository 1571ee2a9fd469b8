"""The runners of the traffic kinds, one module a kind, found by the
``kind`` of a traffic file.  Each has ``inputs``, ``setup``, ``window``,
``stretch`` and ``check`` (see ``run.py``) and ``control``, the readings
of the reference put in the program's place."""
