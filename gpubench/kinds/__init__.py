"""The runners of the traffic kinds, one module a kind, found by the
``kind`` of a traffic file.  Each has ``inputs``, ``setup``, ``window``,
``stretch`` and ``check`` (see ``run.py``), ``control``, the readings of
the reference put in the program's place, and:

* ``WINDOW``: what its window feeds, and so which end-to-end readers read
  it: ``"requests"`` (``ctx.window`` holds ``seconds``, ``graphs``,
  ``request_s``, ``attempted``, ``failed``) or ``"epochs"`` (``seconds``,
  ``graphs``, ``epochs``, ``attempted``, ``failed``, with the rows of an
  epoch in ``ctx.inputs["train"]`` and the traffic's ``val_frequency``);
* ``CONTROLS``: the variants ``control`` takes, each run by
  ``gpubench.calibrate``;
* ``check_config(cfg)``: raises ValueError for a configuration it cannot
  run, before any input is made.
"""
