"""Entries: what a cell's window drives, one file each, found by the name
a traffic file gives under ``entry``.

An entry module has

* ``make(alphabet, era_config, params, device)`` -> the program object;
* ``run(program, s, params)`` -> ``(result, record)``: one build of the
  terminated code string ``s``, returning only once its results are on
  the host; ``record`` holds the program's own reports (``report``, and
  ``stream`` for a streamed build);
* ``keep(result)`` -> the host arrays the comparison reads, cheap enough
  to take inside the window;
* ``TREE``: whether the reference computes the nodes too;
* ``check(kept, ref)`` -> ``{name: entries that differ}``;
* ``control(ref)`` -> a kept output made from the reference's own tables
  (the control put in the program's place).
"""
