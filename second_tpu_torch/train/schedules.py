"""Learning-rate / momentum schedules (twin of
``second_tpu/train/schedules.py``).

Ports of the fastai-style schedules the reference trains with
(torchplus/train/learning_schedules_fastai.py): OneCycle
(super-convergence: cosine lr warmup+anneal with inverse momentum
annealing), staircase exponential decay, manual stepping and the
multi-phase engine. Each builder returns plain ``step -> float``
functions, evaluated on the host once per step in numpy float32 with
the JAX package's order of operations, so the two give the same values
(float64 would part from them by up to ~3e-5 relative near the end of a
cosine, where ``cos + 1`` cancels).

Note: the reference's non-staircase exponential branch drops the
initial_learning_rate factor (learning_schedules_fastai.py:115-117,
upstream bug); as the JAX package, we implement the obviously-intended
``init * factor**(progress/decay_length)``.
"""

import ast

import numpy as np

from ..configs import schema

F32 = np.float32


def annealing_cos(start, end, pct):
    # cos in float64, rounded: closer to XLA's float32 cos than numpy's
    cos_out = F32(np.cos(np.float64(F32(np.pi) * pct))) + F32(1)
    return F32(end) + F32((start - end) / 2) * cos_out


def _clip01(v):
    return np.clip(v, F32(0), F32(1))


def one_cycle(total_step, lr_max, moms, div_factor, pct_start):
    """Returns (lr_schedule, momentum_schedule)."""
    low_lr = lr_max / div_factor
    a1 = max(int(total_step * pct_start), 1)
    a2 = max(total_step - a1, 1)

    def lr_fn(step):
        step = F32(step)
        if step < a1:
            return float(annealing_cos(low_lr, lr_max,
                                       _clip01(step / F32(a1))))
        return float(annealing_cos(lr_max, low_lr / 1e4,
                                   _clip01((step - F32(a1)) / F32(a2))))

    def mom_fn(step):
        step = F32(step)
        if step < a1:
            return float(annealing_cos(moms[0], moms[1],
                                       _clip01(step / F32(a1))))
        return float(annealing_cos(moms[1], moms[0],
                                   _clip01((step - F32(a1)) / F32(a2))))

    return lr_fn, mom_fn


def exponential_decay(total_step, initial_lr, decay_length, decay_factor,
                      staircase=True):
    assert 0 < decay_length < 1
    decay_steps = decay_length * total_step

    def lr_fn(step):
        n = F32(step) / F32(decay_steps)
        if staircase:
            n = np.floor(n)
        return float(F32(initial_lr) * np.power(F32(decay_factor), n))

    return lr_fn


def manual_stepping(total_step, boundaries, rates):
    assert len(rates) == len(boundaries) + 1
    bsteps = np.asarray([b * total_step for b in boundaries], F32)
    rates = np.asarray(rates, F32)

    def lr_fn(step):
        return float(rates[int(np.sum(F32(step) >= bsteps))])

    return lr_fn


# --- multi_phase: the reference evals user lambda strings from the config
# (lr_scheduler_builder.py:71-77 + learning_schedules_fastai.py:16,31 use
# bare eval). We validate the expression tree first and expose only a
# small math whitelist — same config surface, no arbitrary code.

_LAMBDA_FUNCS = {
    "annealing_cos": annealing_cos,
    "sin": np.sin, "cos": np.cos, "exp": np.exp, "log": np.log,
    "sqrt": np.sqrt, "abs": np.abs, "pow": np.power,
    "min": np.minimum, "max": np.maximum, "pi": np.pi,
}

_ALLOWED_NODES = (
    ast.Expression, ast.Lambda, ast.arguments, ast.arg, ast.Name,
    ast.Load, ast.Constant, ast.BinOp, ast.UnaryOp, ast.IfExp,
    ast.Compare, ast.BoolOp, ast.Call, ast.Add, ast.Sub, ast.Mult,
    ast.Div, ast.Pow, ast.Mod, ast.FloorDiv, ast.USub, ast.UAdd,
    ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.Eq, ast.NotEq, ast.And,
    ast.Or, ast.Tuple, ast.keyword,
)


def parse_lambda(src):
    """Parse a config lambda string (e.g. ``"lambda x: x * 0.1"``) into a
    callable, restricted to arithmetic + the math whitelist above."""
    tree = ast.parse(src.strip(), mode="eval")
    if not isinstance(tree.body, ast.Lambda):
        raise ValueError(f"multi_phase lambda_func must be a lambda: {src!r}")
    lam = tree.body
    if len(lam.args.args) != 1 or lam.args.vararg or lam.args.kwarg:
        raise ValueError(
            f"multi_phase lambda must take exactly one argument: {src!r}")
    argname = lam.args.args[0].arg
    allowed_names = set(_LAMBDA_FUNCS) | {argname}
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ValueError(
                f"disallowed syntax {type(node).__name__} in lambda: {src!r}")
        if isinstance(node, ast.Name) and node.id not in allowed_names:
            raise ValueError(
                f"unknown name {node.id!r} in lambda: {src!r}")
        if isinstance(node, ast.Call) and (
                not isinstance(node.func, ast.Name)
                or node.func.id not in _LAMBDA_FUNCS):
            raise ValueError(f"disallowed call in lambda: {src!r}")
    code = compile(tree, "<multi_phase-lambda>", "eval")
    # whitelist goes in globals: a lambda body resolves free names there
    return eval(code, {"__builtins__": {}, **_LAMBDA_FUNCS})


def multi_phase(total_step, lr_phases, mom_phases, default_momentum=0.9):
    """Phase engine (reference LRSchedulerStep,
    learning_schedules_fastai.py:7-56): each phase is (start_fraction,
    lambda_str); at step s the LAST phase with start <= s supplies the
    value, evaluated at pct = (s - start) / (end - start) where end is
    the next phase's start (total_step for the final phase).
    Returns (lr_schedule, momentum_schedule)."""

    def compile_phases(phases):
        spans = []
        for i, (start, src) in enumerate(phases):
            s0 = int(start * total_step)
            if spans:
                assert spans[-1][0] < s0, "phase starts must increase"
            end = (int(phases[i + 1][0] * total_step)
                   if i < len(phases) - 1 else total_step)
            spans.append((s0, end, parse_lambda(src)))
        assert spans[0][0] == 0, "first phase must start at 0"
        return spans

    def make_fn(spans, default):
        def fn(step):
            step = F32(step)
            val = F32(default)
            for s0, end, func in spans:
                if step >= s0:
                    val = F32(func((step - F32(s0)) / F32(max(end - s0, 1))))
            return float(val)
        return fn

    lr_spans = compile_phases(lr_phases)
    lr_fn = make_fn(lr_spans, lr_spans[0][2](F32(0)))
    if mom_phases and any(src for _, src in mom_phases):
        mom_spans = compile_phases(
            [(s, src) for s, src in mom_phases if src])
        mom_fn = make_fn(mom_spans, default_momentum)
    else:
        mom_fn = lambda step: float(F32(default_momentum))  # noqa: E731
    return lr_fn, mom_fn


def build(lr_config: schema.LearningRate, total_step, default_momentum=0.9):
    """LearningRate proto -> (lr_schedule, momentum_schedule)."""
    which = lr_config.WhichOneof("learning_rate")
    if which == "one_cycle":
        c = lr_config.one_cycle
        return one_cycle(
            total_step, c.lr_max, list(c.moms), c.div_factor, c.pct_start)
    if which == "exponential_decay":
        c = lr_config.exponential_decay
        lr_fn = exponential_decay(
            total_step, c.initial_learning_rate, c.decay_length,
            c.decay_factor, c.staircase)
        return lr_fn, (lambda step: float(F32(default_momentum)))
    if which == "manual_stepping":
        c = lr_config.manual_stepping
        lr_fn = manual_stepping(total_step, list(c.boundaries), list(c.rates))
        return lr_fn, (lambda step: float(F32(default_momentum)))
    if which == "multi_phase":
        c = lr_config.multi_phase
        lr_phases = [(p.start, p.lambda_func) for p in c.phases]
        mom_phases = [(p.start, p.momentum_lambda_func) for p in c.phases]
        return multi_phase(total_step, lr_phases, mom_phases,
                           default_momentum)
    raise ValueError("empty learning rate config")
