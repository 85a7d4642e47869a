"""plonky2 vanishing-polynomial terms at zeta.

A copy of `halo2_plonky2_verifier_tpu/refimpl/plonk/vanishing.py`
(`lookup_terms` :39, `eval_vanishing_terms` :90), the single definition of
the term order in the reference; the port keeps it exactly.  Term order
mirrors plonky2 plonk::vanishing_poly::eval_vanishing_poly:

    [ Z-init terms (all challenges) ]
 ++ [ partial-product terms (all challenges, chunk order) ]
 ++ [ lookup terms (all challenges x luts: L_0 boundary + logUp transition) ]
 ++ [ filtered gate-constraint terms (padded to num_gate_constraints) ]

folded per alpha as sum_i alpha^i * term_i (reduce_with_powers).

Lookup argument (logUp): per challenge pair (a, b) and lut, a running-sum
polynomial S satisfies, row by row,

    S(gx) - S(x) =   q_lookup(x) * sum_s 1/(b - (inp_s + a*out_s))
                   - q_table(x)  * sum_s m_s/(b - (t_in_s + a*t_out_s))

with q_* the preprocessed boolean lookup-selector columns, (inp, out) the
LookupGate slot wires, (t_in, t_out) the LookupTableGate slot CONSTANTS and
m_s its multiplicity wires.  Cleared of denominators, the per-row transition
term emitted here is

    q_lk * ((S' - S) * D_lk - N_lk) + q_tbl * ((S' - S) * D_tbl + N_tbl)
        + (1 - q_lk - q_tbl) * (S' - S)

(D = prod of (b - combo), N = sum of numerator products), and the L_0 * S
boundary term pins S(1) = 0.
"""

from .gates import evaluate_gate_constraints


def lookup_terms(F, common, constants, wires, lookup_zs, lookup_zs_next,
                 deltas, l0):
    """The lookup block of the vanishing stream (order: per challenge, per
    lut: [L_0 * S, transition])."""
    cfg = common.config
    one = F.one()
    terms = []
    for i in range(cfg.num_challenges):
        a = F.from_base(deltas[2 * i])
        b = F.from_base(deltas[2 * i + 1])
        for li, lut in enumerate(common.luts):
            S = lookup_zs[i * len(common.luts) + li]
            Sn = lookup_zs_next[i * len(common.luts) + li]
            q_lk = constants[lut.sel_lk]
            q_tbl = constants[lut.sel_tbl]
            Lslots = lut.num_slots
            gc = constants[common.num_selectors:]

            # ONE F.fold over the slots computes both sides' cleared logUp
            # numerators/denominators.  Recurrences:
            #   D' = D * (b - c);  N' = N * (b - c) + num * D
            # give D = prod fac and N = sum_s num_s * prod_{s'!=s} fac.
            xs = [(wires[2 * s], wires[2 * s + 1],
                   gc[2 * s], gc[2 * s + 1], wires[s])
                  for s in range(Lslots)]

            def slot_body(carry, slot):
                Dlk, Nlk, Dtb, Ntb = carry
                w0, w1, t0, t1, m = slot
                f_lk = F.sub(b, F.add(w0, F.mul(a, w1)))
                f_tb = F.sub(b, F.add(t0, F.mul(a, t1)))
                Nlk = F.add(F.mul(Nlk, f_lk), Dlk)           # num = 1
                Dlk = F.mul(Dlk, f_lk)
                Ntb = F.add(F.mul(Ntb, f_tb), F.mul(m, Dtb))
                Dtb = F.mul(Dtb, f_tb)
                return (Dlk, Nlk, Dtb, Ntb), F.zero()

            (D_lk, N_lk, D_tbl, N_tbl), _ = F.fold(
                slot_body, (one, F.zero(), one, F.zero()), xs)
            dacc = F.sub(Sn, S)
            t = F.add(
                F.mul(q_lk, F.sub(F.mul(dacc, D_lk), N_lk)),
                F.mul(q_tbl, F.add(F.mul(dacc, D_tbl), N_tbl)))
            t = F.add(t, F.mul(F.sub(F.sub(one, q_lk), q_tbl), dacc))
            terms.append(F.mul(l0, S))
            terms.append(t)
    return terms


def eval_vanishing_terms(F, common, x, constants, sigmas, wires, zs, zs_next,
                         partial_products, pi_hash, betas, gammas, l0,
                         lookup_zs=(), lookup_zs_next=(), deltas=()):
    """Returns the ordered list of vanishing terms at point `x`.

    constants: num_constants values (selectors ++ gate constants ++ lookup
               selectors)
    sigmas:    num_routed_wires values
    zs/zs_next/partial_products: per plonky2 openings layout
    betas/gammas: base-field challenge ints; l0: L_0(x) in F.
    lookup_zs/lookup_zs_next/deltas: logUp S openings and the (a, b)
               challenge pairs (2 per challenge), required iff common.luts.
    """
    cfg = common.config
    r = cfg.num_routed_wires
    q = common.quotient_degree_factor
    npp = common.num_partial_products
    one = F.one()

    z1_terms = [F.mul(l0, F.sub(zs[i], one)) for i in range(cfg.num_challenges)]

    pp_terms = []
    for i in range(cfg.num_challenges):
        beta = F.from_base(betas[i])
        gamma = F.from_base(gammas[i])
        accs = ([zs[i]]
                + partial_products[i * npp:(i + 1) * npp]
                + [zs_next[i]])
        for t in range(npp + 1):
            lo, hi = t * q, min((t + 1) * q, r)
            # f_j = w_j + beta * k_j * x + gamma; g_j = w_j + beta*sigma_j
            # + gamma, folded once per chunk
            xs = [(wires[j], sigmas[j], F.from_base(common.k_is[j]))
                  for j in range(lo, hi)]

            def fg_body(carry, wsk):
                pf, pg = carry
                w, s, k = wsk
                f = F.add(F.add(w, F.mul(beta, F.mul(k, x))), gamma)
                g = F.add(F.add(w, F.mul(beta, s)), gamma)
                return (F.mul(pf, f), F.mul(pg, g)), F.zero()

            (prod_f, prod_g), _ = F.fold(fg_body, (one, one), xs)
            pp_terms.append(F.sub(F.mul(accs[t + 1], prod_g),
                                  F.mul(accs[t], prod_f)))

    lu_terms = []
    if common.luts:
        lu_terms = lookup_terms(F, common, constants, wires, lookup_zs,
                                lookup_zs_next, deltas, l0)

    gate_terms = evaluate_gate_constraints(
        F, common.gates, common.selector_groups, constants, wires, pi_hash,
        common.num_gate_constraints, common.num_selectors)
    return z1_terms + pp_terms + lu_terms + gate_terms
