"""One module per entry point of the program that a mix drives, named by the
mix's ``entry``.  Each defines ``Driver(cfg, mix, seed, device)``:

* its constructor is the set-up: it imports the program, builds the code,
  makes the pool's bytes from the seed and encodes what the traffic needs,
  and records the seconds of each step in ``split``;
* ``warm(ops)`` runs each distinct operation once; ``arm()`` readies the
  pool for the window, after the warm-up and any counting pass;
* ``issue(op)`` enqueues one operation through the program and returns its
  output; ``keep(op, out)`` offers it to the seeded sample that is judged;
  ``credit_bytes``, ``blocks_per_op`` and ``stripes_per_op`` say what an
  operation does;
* ``release()`` drops the program's own state once the window has closed;
  ``judge()`` then compares what the timed path produced with the plain
  reference and returns the numbers compared;
* ``use_control(field)`` puts the reference, computed over another field, in
  the program's place (``perfbench/control.py`` only).
"""
