"""Operations and bytes of the LSTM policy, counted on the algorithm.

The counts behind the repository's kernel table: a matrix product counts
2mnk; each elementwise op one per output element (the bias adds, three
sigmoids, two tanh, the products and the sum of the cell). A cell of input
width d and n units, per env; a pair is the same layer of both towers with
the state reset by the done mask (one subtraction and four products of n).
"""


def cell_ops(d: int, n: int) -> int:
    return 2 * 4 * n * (d + n) + 2 * 4 * n + 3 * n + n + 4 * n + n


def pair_ops(d: int, n: int) -> int:
    return 2 * cell_ops(d, n) + 1 + 4 * n


def pair_bytes(batch: int, d: int, n: int) -> int:
    """Inputs and states read, weights read once, states written; float32."""
    one = 4 * (batch * d + 2 * batch * n + (d + n) * 4 * n + 4 * n + 2 * batch * n)
    return 2 * one + 4 * batch


def heads_ops(n: int, act: int) -> int:
    """The policy mean and the value head of one env."""
    return 2 * n * act + act + 2 * n + 1


def policy_step_ops(obs: int, widths, act: int) -> int:
    """One control step of both towers and both heads, per env."""
    ops, d = 0, obs
    for n in widths:
        ops += pair_ops(d, n)
        d = n
    return ops + heads_ops(widths[-1], act)


def seq_forward_ops(T: int, batch: int, d: int, n: int) -> int:
    """The sequence forward of one layer of both towers: the pair, T times."""
    return T * batch * pair_ops(d, n)


def seq_forward_bytes(T: int, batch: int, d: int, n: int) -> int:
    """x, the initial state, [Wx; Wh], b and the mask read, c_seq, h_seq and
    the gates written, both towers."""
    return 4 * (2 * (T * batch * d + 2 * batch * n + (d + n + 1) * 4 * n + T * batch * 6 * n)
                + T * batch)


def seq_backward_ops(T: int, batch: int, d: int, n: int, dx: bool) -> int:
    """dgates, dc, dh (and dx) over the sequence, both towers."""
    cols = d if dx else 0
    return 2 * T * (2 * batch * 4 * n * (n + cols) + 29 * batch * n)


def seq_backward_bytes(T: int, batch: int, d: int, n: int, dx: bool) -> int:
    cols = d if dx else 0
    k = 2 if dx else 1
    return 4 * (2 * (T * batch * (8 * n + n + n + cols) + batch * n + 4 * n * n * k
                     + 2 * batch * n) + T * batch)


def weight_grad_ops(T: int, batch: int, d: int, n: int) -> int:
    """dWx, dWh and db of one layer of both towers from the sequence's gates."""
    return 2 * (2 * T * batch * (d + n) * 4 * n + T * batch * 4 * n)


def n_params(obs: int, widths, act: int) -> int:
    total, d = 0, obs
    for n in widths:
        total += 2 * ((d + n) * 4 * n + 4 * n)
        d = n
    return total + widths[-1] * act + act + act + widths[-1] + 1


def update_ops(T: int, batch: int, epochs: int, obs: int, widths, act: int,
               env_step_ops: int) -> int:
    """One PPO update: the rollout's policy steps and env steps, then each
    epoch's sequence forward, its backward (the sequence kernels' part, the
    weight gradients and the heads') and Adam; no recomputation."""
    rollout = T * batch * (policy_step_ops(obs, widths, act) + env_step_ops)
    fwd = T * batch * policy_step_ops(obs, widths, act)
    bwd, d = 0, obs
    for i, n in enumerate(widths):
        bwd += seq_backward_ops(T, batch, d, n, dx=i > 0) + weight_grad_ops(T, batch, d, n)
        d = n
    bwd += 2 * T * batch * heads_ops(widths[-1], act)
    adam = 12 * n_params(obs, widths, act)
    return rollout + epochs * (fwd + bwd + adam)
