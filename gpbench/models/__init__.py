"""The models a configuration can name: `configs/<config>.json`'s `model`
picks `models/<model>.py`, which gives the harness everything that is
particular to the model:

  * `draw(shape, seed, device, perturb=None)`: (params, data), the same
    tensors for the program and the reference; `data` is a tuple, passed
    on as it is (`(Y,)`, `(X, Y)`);
  * `Program(config, lr, mesh=None, device="cuda")`: the calls into the
    program that a cell drives, with `dtype`, `adam` (its `lr`), `mesh`,
    `local_keys` (the parameters a rank holds its own rows of),
    `place(params, data)`, `adam_init(params)`, `train_step(params, opt,
    data)` -> (params, opt, the loss before the update), and, where the
    model has one, `build(params, data)`;
  * `reference`: the plain reference module (`Numerics`, `cast`,
    `adam_init`, `adam_update`, `value_and_grad(params, *data, num)`,
    `train(params, *data, steps, lr, num)`, and `build(params, *data, num)`
    where the model has one);
  * `STATS_OPS`: by traffic kind, the autograd ops whose traced device time
    the readers take, each with its calls a step or build;
    `timed_alone(params, data, dev)`: for each op, (fn, args, calls):
    `fn(*args)` launches the kernels of that many calls outside autograd,
    or None where the program has no such entry;
  * `STEP_WORK`: by traffic kind, the least work of a step or build
    (`gpbench.work`); `ROOFLINES`: by kernel, (its op, its least work);
  * `FAULTS`: the faults planted under the model's timed path (`half`,
    `alter`), each a context manager (`gpbench/faults.py` adds the
    control, `unchanged` and the faults of several cards).

A model is added as a new module here, with its reference under
`reference/`; nothing else needs an edit.
"""
