"""Thompson 2-moment bulk microphysics (Thompson et al. 2004, 2008).

JAX re-implementation of the column scheme in
/root/reference/src/physics/mp_thompson.f90 (mp_thompson, lines
1057-2844; driver mp_gt_driver, lines 772-1044), vectorized over the full
(z, y, x) grid instead of per-column loops. Six water species (vapor,
cloud, ice, rain, snow, graupel) with prognostic ice and rain number;
snow follows the Field et al. (2005) two-gamma distribution with
temperature-dependent moment relations; collision and freezing integrals
come from the host-built lookup tables in `thompson_tables` and are read
with vectorized gathers.

Deliberate divergences from the reference (documented):
- sedimentation flux divergence is applied at every level below the top
  rather than only below `ksed1` (the highest level with fallspeed
  > 1 mm/s); levels above differ only by fluxes of the R1=1e-12 floor.
- the per-column `no_micro` early exit is dropped (SIMD grids compute
  everywhere; results are identical because every process is masked).

Layout (z, y, x), level 0 = surface. All inputs/outputs float32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
import numpy as np

from . import thompson_tables as tt
from .thompson_tables import (AM_I, AM_R, ATO, AV_R, BM_G, BM_I, BM_R, BM_S,
                              BV_I, BV_R, C_CUBE, CP2, D0C, D0G, D0R, D0S,
                              EPS, FV_R, GONV_MAX, GONV_MIN, HGFR, KAP0, KAP1,
                              LAM0, LAM1, LFUS, LSUB, LVAP0, MU_S, NBC, NBR,
                              NBS, NTB_C, NTB_G, NTB_G1, NTB_I, NTB_I1, NTB_R,
                              NTB_R1, NTB_S, NTB_T, PI, R1, R2, RHO_NOT, RHO_W,
                              RR2, RV, SA, SB, XM0I, ThompsonParams,
                              get_tables)

T_0 = 273.15
ORV = 1.0 / RV
OLFUS = 1.0 / LFUS


def rslf(p, t):
    """Liquid saturation mixing ratio, Flatau et al. 1992 polynomial
    (mp_thompson.f90:3776-3805)."""
    x = jnp.maximum(-80.0, t - 273.16)
    C = (0.611583699e3, 0.444606896e2, 0.143177157e1, 0.264224321e-1,
         0.299291081e-3, 0.203154182e-5, 0.702620698e-8, 0.379534310e-11,
         -0.321582393e-13)
    esl = C[8]
    for cc in C[7::-1]:
        esl = cc + x * esl
    return 0.622 * esl / (p - esl)


def rsif(p, t):
    """Ice saturation mixing ratio (mp_thompson.f90:3812-3835)."""
    x = jnp.maximum(-80.0, t - 273.16)
    C = (0.609868993e3, 0.499320233e2, 0.184672631e1, 0.402737184e-1,
         0.565392987e-3, 0.521693933e-5, 0.307839583e-7, 0.105785160e-9,
         0.161444444e-12)
    esi = C[8]
    for cc in C[7::-1]:
        esi = cc + x * esi
    return 0.622 * esi / (p - esi)


def _field_ab(tc, n):
    """Field et al. (2005) moment coefficients a(n,Tc), b(n,Tc);
    n is a Python float, tc an array."""
    loga = (SA[0] + SA[1] * tc + SA[2] * n + SA[3] * tc * n
            + SA[4] * tc * tc + SA[5] * n * n + SA[6] * tc * tc * n
            + SA[7] * tc * n * n + SA[8] * tc ** 3 + SA[9] * n ** 3)
    b = (SB[0] + SB[1] * tc + SB[2] * n + SB[3] * tc * n
         + SB[4] * tc * tc + SB[5] * n * n + SB[6] * tc * tc * n
         + SB[7] * tc * n * n + SB[8] * tc ** 3 + SB[9] * n ** 3)
    return 10.0 ** loga, b


def _field_moment(tc, n, smo2):
    a, b = _field_ab(tc, float(n))
    return a * smo2 ** b


def _mantissa_idx(r, lo_exp, ntb):
    """Decimal table index: value m*10^e maps to int(m) + 9*(e - lo_exp)
    (the reference's goto-141 style mantissa search, 0-based here)."""
    n = jnp.floor(jnp.log10(jnp.maximum(r, 1e-30)))
    mant = r / 10.0 ** n
    idx = jnp.trunc(mant).astype(jnp.int32) + 9 * (n.astype(jnp.int32)
                                                   - lo_exp) - 1
    return jnp.clip(idx, 0, ntb - 1)


def _nint(x):
    return jnp.floor(x + 0.5).astype(jnp.int32)


def _filldown(vt, present):
    """vt(k) = vt(k) if species present else value from the level above
    (reference's vtxk(k)=vtxk(k+1) top-down carry). Unrolled over the
    (static, small) z extent instead of lax.scan; the where-chain is
    bit-identical to the scan."""
    nz = vt.shape[0]
    acc = jnp.zeros_like(vt[:1])
    rows = []
    for k in range(nz - 1, -1, -1):
        acc = jnp.where(present[k:k + 1], vt[k:k + 1], acc)
        rows.append(acc)
    return jnp.concatenate(rows[::-1], axis=0)


def _cummin_rev(x):
    """Reverse (top-down) cumulative minimum over axis 0 — an unrolled
    replacement for lax.cummin(axis=0, reverse=True); min chains are
    exact so the result is bit-identical."""
    nz = x.shape[0]
    acc = x[nz - 1:nz]
    rows = [acc]
    for k in range(nz - 2, -1, -1):
        acc = jnp.minimum(x[k:k + 1], acc)
        rows.append(acc)
    return jnp.concatenate(rows[::-1], axis=0)


def _sediment(rx, nx_, vt_m, vt_n, rho, dz, DT, with_number,
              floor_m=R1, floor_n=R2, vt_for_cfl=None):
    """Explicit flux-form sedimentation with per-column substepping
    (mp_thompson.f90:2657-2780). Returns updated (rx, nx_, qten_sed,
    nten_sed, surface_flux_sum [kg/m^2] with a leading singleton level
    axis). All reductions keep dims, so no rank changes — bit-identical
    to the squeezed formulation."""
    if vt_for_cfl is None:
        vt_for_cfl = jnp.maximum(vt_m, vt_n) if with_number else vt_m
    per_k = jnp.where(vt_for_cfl > 1e-3,
                      jnp.trunc(DT * vt_for_cfl / dz).astype(jnp.int32) + 1,
                      0)
    nstep = jnp.maximum(jnp.max(per_k, axis=0, keepdims=True), 1)
    onstep = 1.0 / nstep.astype(rx.dtype)
    n_max = jnp.max(nstep)
    odzq = 1.0 / dz
    orho = 1.0 / rho

    def body(carry):
        s, rx, nx_, qten, nten, sfc = carry
        active = (s < nstep)                             # (1, ...)
        sed_m = vt_m * rx
        zero = jnp.zeros_like(sed_m[:1])
        div_m = jnp.concatenate([sed_m[1:], zero], 0) - sed_m
        d_q = div_m * odzq * onstep * orho
        rx_new = jnp.maximum(floor_m, rx + div_m * odzq * DT * onstep)
        qten_new = qten + d_q
        sfc_inc = jnp.where(rx_new[:1] > R1 * 10.0,
                            sed_m[:1] * DT * onstep, 0.0)
        if with_number:
            sed_n = vt_n * nx_
            div_n = jnp.concatenate([sed_n[1:], zero], 0) - sed_n
            nten_new = nten + div_n * odzq * onstep * orho
            nx_new = jnp.maximum(floor_n,
                                 nx_ + div_n * odzq * DT * onstep)
        else:
            nten_new, nx_new = nten, nx_
        return (s + 1,
                jnp.where(active, rx_new, rx),
                jnp.where(active, nx_new, nx_),
                jnp.where(active, qten_new, qten),
                jnp.where(active, nten_new, nten),
                sfc + jnp.where(active, sfc_inc, 0.0))

    zten = jnp.zeros_like(rx)
    sfc0 = jnp.zeros_like(rx[:1])
    _, rx, nx_, qten, nten, sfc = lax.while_loop(
        lambda c: c[0] < n_max, body,
        (jnp.int32(0), rx, nx_, zten, jnp.zeros_like(rx), sfc0))
    return rx, nx_, qten, nten, sfc


def _snow_moments(rs, temp, c):
    """Field et al. snow moments from the 2nd (= bm_s-th) moment
    (mp_thompson.f90:1375-1450)."""
    tc0 = jnp.minimum(-0.1, temp - 273.15)
    smob = rs * c.oams
    smo2 = smob                                     # bm_s == 2
    # 0th moment uses only the tc0-dependent coefficient subset
    loga0 = SA[0] + SA[1] * tc0 + SA[4] * tc0 ** 2 + SA[8] * tc0 ** 3
    b0 = SB[0] + SB[1] * tc0 + SB[4] * tc0 ** 2 + SB[8] * tc0 ** 3
    smo0 = 10.0 ** loga0 * smo2 ** b0
    smo1 = _field_moment(tc0, 1.0, smo2)
    smoc = _field_moment(tc0, float(c.cse[0]), smo2)
    smod = _field_moment(tc0, float(c.cse[13]), smo2)
    smoe = _field_moment(tc0, float(c.cse[12]), smo2)
    smof = _field_moment(tc0, float(c.cse[15]), smo2)
    return smob, smo2, smo0, smo1, smoc, smod, smoe, smof


def _graupel_intercept(rg, temp, mvd_r, has_rain, c):
    """Mixing-ratio-dependent graupel intercept with the top-down
    running minimum (mp_thompson.f90:1455-1489)."""
    xslw1 = jnp.where((temp < 270.65) & has_rain & (mvd_r > 100e-6),
                      4.01 + jnp.log10(mvd_r), 0.01)
    ygra1 = 4.31 + jnp.log10(jnp.maximum(5e-5, rg))
    zans1 = 3.1 + (100. / (300. * xslw1 * ygra1
                           / (10. / xslw1 + 1. + 0.25 * ygra1)
                           + 30. + 10. * ygra1))
    N0_exp = jnp.clip(10.0 ** zans1, GONV_MIN, GONV_MAX)
    # running min from the model top downward
    N0_exp = _cummin_rev(N0_exp)
    lam_exp = (N0_exp * c.am_g * c.cgg[0] / rg) ** c.oge1
    lamg = lam_exp * (c.cgg[2] * c.ogg2 * c.ogg1) ** c.obmg
    ilamg = 1.0 / lamg
    N0_g = N0_exp / (c.cgg[1] * lam_exp) * lamg ** c.cge[1]
    return ilamg, N0_g


def _rain_slope(rr, nr, c):
    lamr = (AM_R * c.crg[2] * c.org2 * nr / rr) ** c.obmr
    ilamr = 1.0 / lamr
    mvd_r = (3.0 + c.mu_r + 0.672) / lamr
    N0_r = nr * c.org2 * lamr ** c.cre[1]
    return ilamr, mvd_r, N0_r


def _rain_nr_from_mvd(rr, mvd, c):
    lamr = (3.0 + c.mu_r + 0.672) / mvd
    return c.crg[1] * c.org3 * rr * lamr ** BM_R / AM_R


# lookup-table groups sharing an index tuple; each group becomes ONE
# XLA gather (or one pair of one-hot matmuls for the small 2D tables):
# one index computation and one gather serve every table of the group
# (the reference reads each table separately: qr_acr_qs / qr_acr_qg /
# freezeH2O / qi_aut_qs, mp_thompson.f90:1700-1955).
_RACS_NAMES = ("tcs_racs1", "tcs_racs2", "tmr_racs1", "tmr_racs2",
               "tcr_sacr1", "tcr_sacr2", "tms_sacr1", "tms_sacr2",
               "tnr_racs1", "tnr_racs2", "tnr_sacr1", "tnr_sacr2")
_RACG_NAMES = ("tmr_racg", "tcr_gacr", "tnr_racg", "tnr_gacr", "tcg_racg")
_QRFZ_NAMES = ("tpg_qrfz", "tpi_qrfz", "tni_qrfz", "tnr_qrfz")
_QCFZ_NAMES = ("tpi_qcfz", "tni_qcfz")
_IAUS_NAMES = ("tpi_ide", "tps_iaus", "tni_iaus")
_PREP_CACHE = {}


def _prep_tables(params):
    """get_tables + pre-stacked numpy groups (built once per parameter
    set, outside any trace so nothing is constant-folded at compile).

    The three big gather stacks are stored BFLOAT16, halving the bytes a
    random-access gather touches. bf16
    quantization (<=0.4% relative) of the frozen-process collection/
    freezing rate tables is a deliberate, documented storage-precision
    divergence from the reference's f32 tables: the warm-rain
    transcription oracle is unaffected (frozen masses are zero there)
    and the cold-process oracle quantizes its own lookups identically,
    so the process LOGIC remains tested at full tightness."""
    key = tuple(sorted(vars(params).items()))
    if key not in _PREP_CACHE:
        import ml_dtypes
        t, _ = get_tables(params)
        prep = dict(t)
        for gname, names in (("racs", _RACS_NAMES), ("racg", _RACG_NAMES),
                             ("qrfz", _QRFZ_NAMES)):
            prep["_stk_" + gname] = np.stack(
                [t[n].reshape(-1) for n in names]).astype(
                    ml_dtypes.bfloat16)
        for gname, names in (("qcfz", _QCFZ_NAMES), ("iaus", _IAUS_NAMES),
                             ("efrw", ("t_Efrw",)), ("efsw", ("t_Efsw",))):
            prep["_stk_" + gname] = np.stack([t[n] for n in names])
        _PREP_CACHE[key] = prep
    return _PREP_CACHE[key]


def _take_tables(T, names, idxs, stk):
    """One stacked flat gather serving every table in a group: the
    stacked (N, ...) gather output, in the table's storage dtype
    (bfloat16 for the big groups)."""
    dims = T[names[0]].shape
    lin = idxs[0]
    for d, ix in zip(dims[1:], idxs[1:]):
        lin = lin * d + ix
    return jnp.take(jnp.asarray(T[stk]), lin, axis=1)


def _onehot_tables(T, names, ia, ib, dtype, stk):
    """Exact 2D table lookup as two one-hot contractions (bit-exact
    because each output is 1.0*value + exact zeros under HIGHEST
    precision, which also keeps the contraction out of TF32)."""
    tab = jnp.asarray(T[stk])                 # (NT, A, B)
    nt, a_dim, b_dim = tab.shape
    sh = ia.shape
    oa = (ia.reshape(-1)[:, None]
          == jnp.arange(a_dim, dtype=ia.dtype)).astype(dtype)
    rows = jax.lax.dot_general(
        oa, tab.astype(dtype), (((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST)  # (n, NT, B)
    ob = (ib.reshape(-1)[:, None]
          == jnp.arange(b_dim, dtype=ib.dtype)).astype(dtype)
    vals = jnp.sum(rows * ob[:, None, :], axis=-1)
    return {n: vals[:, i].reshape(sh) for i, n in enumerate(names)}


def _thermo(temp, pres, qv):
    tempc = temp - 273.15
    rho = 0.622 * pres / (RR2 * temp * (qv + 0.622))
    rhof = jnp.sqrt(RHO_NOT / rho)
    rhof2 = jnp.sqrt(rhof)
    diffu = 2.11e-5 * (temp / 273.15) ** 1.94 * (101325. / pres)
    visco = jnp.where(tempc >= 0.0,
                      (1.718 + 0.0049 * tempc) * 1e-5,
                      (1.718 + 0.0049 * tempc
                       - 1.2e-5 * tempc * tempc) * 1e-5)
    ocp = 1.0 / (CP2 * (1.0 + 0.887 * qv))
    vsc2 = jnp.sqrt(rho / visco)
    lvap = LVAP0 + (2106.0 - 4218.0) * tempc
    tcond = (5.69 + 0.0168 * tempc) * 1e-5 * 418.936
    return rho, rhof, rhof2, diffu, visco, ocp, vsc2, lvap, tcond


def _nu_c_jnp(ncr):
    """Per-cell cloud shape parameter nu_c = MIN(15, NINT(1e9/nc)+2)
    (mp_thompson_aer.f90:1655). ncr in m^-3."""
    return jnp.clip(jnp.rint(1000e6 / ncr).astype(jnp.int32) + 2, 2, 15)


def _g_ratios(nu_c):
    """Integer gamma ratios of the nu_c family: g1 = G(nu+4)/G(nu+1),
    g2 = G(nu+7)/G(nu+4) (ccg(2)*ocg1 and ccg(3)*ocg2 of
    mp_thompson_aer.f90:627-638, bm_r = 3)."""
    nu = nu_c.astype(jnp.float32)
    g1 = (nu + 1.) * (nu + 2.) * (nu + 3.)
    g2 = (nu + 4.) * (nu + 5.) * (nu + 6.)
    return g1, g2


def _eff_aero(D, Da, visco, rho, temp, vt):
    """Aerosol collection efficiency by a collector of diameter D falling
    at vt (Eff_aero, mp_thompson_aer.f90:4993-5024)."""
    boltzman = 1.3806503e-23
    meanPath = 0.0256e-6
    Cc = 1. + 2. * meanPath / Da * (1.257 + 0.4 * jnp.exp(-0.55 * Da
                                                          / meanPath))
    diff = boltzman * temp * Cc / (3. * PI * visco * Da)
    Re = 0.5 * rho * D * vt / visco
    Sc = visco / (rho * diff)
    St = Da * Da * vt * 1000. / (9. * visco * D)
    aval = 1. + jnp.log(1. + Re)
    St2 = (1.2 + 1. / 12. * aval) / (1. + aval)
    Eff = (4. / (Re * Sc) * (1. + 0.4 * jnp.sqrt(Re) * Sc ** (1. / 3.)
                             + 0.16 * jnp.sqrt(Re) * jnp.sqrt(Sc))
           + 4. * Da / D * (0.02 + Da / D * (1. + 2. * jnp.sqrt(Re))))
    Eff = Eff + jnp.where(St > St2,
                          ((St - St2) / (St - St2 + 0.666667)) ** 1.5, 0.0)
    return jnp.clip(Eff, 1e-5, 1.0)


def _ice_demott(tempc, rho, nifa):
    """Heterogeneous ice nuclei from dust/mineral aerosol, DeMott et al.
    (2010) (iceDeMott, mp_thompson_aer.f90:4879-4949; only the DeMott-2010
    branch is live in the reference — the Phillips path is commented out).
    nifa in m^-3; returns m^-3."""
    nifa_cc = nifa * tt.RHO_NOT0 * 1e-6 / rho
    xni = (5.94e-5 * (-tempc) ** 3.33) \
        * (nifa_cc ** ((-0.0264 * tempc) + 0.0033))
    xni = xni * rho / tt.RHO_NOT0 * 1000.0
    return jnp.maximum(0.0, xni)


def _ice_koop(temp, qv, qvs, nwfa, dt):
    """Homogeneous freezing of deliquesced aerosols, Koop et al. (2001)
    (iceKoop, mp_thompson_aer.f90:4955-4979). Returns m^-3."""
    R_uni = 8.314
    satw = qv / qvs
    mu_diff = (210368.0 + 131.438 * temp - 3.32373e6 / temp
               - 41729.1 * jnp.log(temp))
    a_w_i = jnp.exp(mu_diff / (R_uni * temp))
    delta_aw = satw - a_w_i
    log_J = (-906.7 + 8502.0 * delta_aw - 26924.0 * delta_aw ** 2
             + 29180.0 * delta_aw ** 3)
    J_rate = 10.0 ** jnp.minimum(20.0, log_J)
    prob_h = jnp.minimum(1. - jnp.exp(-J_rate * tt.AR_VOLUME * dt), 1.)
    return jnp.maximum(0.0, jnp.minimum(prob_h * nwfa, 1000e3))


# ---------------------------------------------------------------------------
# staged pipeline blocks
#
# The scheme runs as prep -> table indices -> table lookups -> core
# (rates / conservation / tau+1 update / condensation / rain evap /
# terminal velocities) -> sedimentation -> final update.
# ---------------------------------------------------------------------------


def _prep_block(th, qv1d, qc1d, qi1d, qr1d, qs1d, qg1d, ni1d, nr1d,
                exner, p1d, c, pp, nc1d=None, nwfa1d=None, nifa1d=None,
                w1d=None):
    """Hydrometeor loads/clamps, thermodynamics, saturation, snow moments
    and PSD slopes/intercepts (mp_thompson.f90:1160-1494). Returns the
    prep dict P; its q*1d/n*1d entries are the MASKED (q > R1) versions
    the rest of the scheme consumes."""
    aer = nc1d is not None

    t1d = th * exner
    temp = t1d
    qv = jnp.maximum(1e-10, qv1d)
    pres = p1d
    rho = 0.622 * pres / (RR2 * temp * (qv + 0.622))

    L_qc = qc1d > R1
    qc1d = jnp.where(L_qc, qc1d, 0.0)
    rc = jnp.where(L_qc, qc1d * rho, R1)

    P = {}
    if aer:
        # working aerosol concentrations in m^-3 (mp_thompson_aer.f90:
        # 1649-1650) and droplet-number init with the mean-size clamp into
        # [D0c, 2*D0r] (:1653-1667)
        nwfa = jnp.clip(nwfa1d * rho, 11.1e6, 9999.0e6)
        nifa = jnp.clip(nifa1d * rho, tt.NA_IN1 * 0.01, 9999.0e6)
        nc1d = jnp.where(L_qc, nc1d, 0.0)
        ncr = jnp.maximum(2.0, nc1d * rho)
        nu_c0 = _nu_c_jnp(ncr)
        g1_0, _ = _g_ratios(nu_c0)
        lamc0 = (ncr * AM_R * g1_0 / rc) ** c.obmr
        xDc0 = (BM_R + nu_c0 + 1.0) / lamc0
        cce2 = BM_R + nu_c0.astype(jnp.float32) + 1.0
        lamc_cl = jnp.where(xDc0 < D0C, cce2 / D0C,
                            jnp.where(xDc0 > D0R * 2., cce2 / (D0R * 2.),
                                      lamc0))
        ncr = jnp.where(L_qc,
                        jnp.minimum(tt.NT_C_MAX,
                                    rc / (AM_R * g1_0) * lamc_cl ** BM_R),
                        2.0)
        w1d = jnp.zeros_like(temp) if w1d is None else w1d
        P.update(nc1d=nc1d, ncr=ncr, nwfa=nwfa, nifa=nifa, w1d=w1d,
                 nwfa1d=nwfa1d, nifa1d=nifa1d)

    L_qi = qi1d > R1
    qi1d = jnp.where(L_qi, qi1d, 0.0)
    ni1d = jnp.where(L_qi, ni1d, 0.0)
    ri = jnp.where(L_qi, qi1d * rho, R1)
    ni = jnp.where(L_qi, jnp.maximum(R2, ni1d * rho), R2)
    # clamp ice mean size into [20, 300] microns by adjusting number
    lami = (AM_I * c.cig[1] * c.oig1 * ni / ri) ** c.obmi
    xDi = (BM_I + c.mu_i + 1.0) / lami
    lami_lo = c.cie[1] / 20e-6
    lami_hi = c.cie[1] / 300e-6
    ni_lo = jnp.minimum(250e3, c.cig[0] * c.oig2 * ri / AM_I
                        * lami_lo ** BM_I)
    ni_hi = c.cig[0] * c.oig2 * ri / AM_I * lami_hi ** BM_I
    ni = jnp.where(L_qi & (xDi < 20e-6), ni_lo,
                   jnp.where(L_qi & (xDi > 300e-6), ni_hi, ni))

    L_qr = qr1d > R1
    qr1d = jnp.where(L_qr, qr1d, 0.0)
    nr1d = jnp.where(L_qr, nr1d, 0.0)
    rr = jnp.where(L_qr, qr1d * rho, R1)
    nr = jnp.where(L_qr, jnp.maximum(R2, nr1d * rho), R2)
    lamr = (AM_R * c.crg[2] * c.org2 * nr / rr) ** c.obmr
    mvd_r = (3.0 + c.mu_r + 0.672) / lamr
    mvd_clamped = jnp.clip(mvd_r, D0R * 0.75, 2.5e-3)
    nr = jnp.where(L_qr & (mvd_r != mvd_clamped),
                   _rain_nr_from_mvd(rr, mvd_clamped, c), nr)
    mvd_r = jnp.where(L_qr, mvd_clamped, 0.0)

    L_qs = qs1d > R1
    qs1d = jnp.where(L_qs, qs1d, 0.0)
    rs = jnp.where(L_qs, qs1d * rho, R1)
    L_qg = qg1d > R1
    qg1d = jnp.where(L_qg, qg1d, 0.0)
    rg = jnp.where(L_qg, qg1d * rho, R1)

    # thermodynamics
    tempc = temp - 273.15
    rho, rhof, rhof2, diffu, visco, ocp, vsc2, lvap, tcond = \
        _thermo(temp, pres, qv)
    qvs = rslf(pres, temp)
    delQvs = jnp.maximum(0.0, rslf(pres, jnp.full_like(temp, 273.15)) - qv)
    qvsi = jnp.where(tempc <= 0.0, rsif(pres, temp), qvs)
    satw = qv / qvs
    sati = qv / qvsi
    ssatw = jnp.where(jnp.abs(satw - 1.) < EPS, 0.0, satw - 1.)
    ssati = jnp.where(jnp.abs(sati - 1.) < EPS, 0.0, sati - 1.)

    # snow moments + graupel/rain intercepts
    smob, smo2, smo0, smo1, smoc, smod, smoe, smof = \
        _snow_moments(rs, temp, c)
    ilamg, N0_g = _graupel_intercept(rg, temp, mvd_r, L_qr, c)
    ilamr, mvd_r, N0_r = _rain_slope(rr, nr, c)

    zero = jnp.zeros_like(temp)

    # cloud-droplet PSD (mp_thompson.f90:1500-1511 / aer :1955-1980);
    # shared by the warm-rain rates and the collision-efficiency table
    # indices
    if aer:
        nu_cw = _nu_c_jnp(ncr)
        g1w, g2w = _g_ratios(nu_cw)
        xDc = jnp.maximum(D0C * 1e6, ((rc / (AM_R * ncr)) ** c.obmr) * 1e6)
        lamc = (ncr * AM_R * g1w / rc) ** c.obmr
        mvd_c = jnp.where(L_qc, (3.0 + nu_cw + 0.672) / lamc, D0C)
        Dc_g = (g2w ** c.obmr / lamc) * 1e6
        P.update(nu_cw=nu_cw)
    else:
        xDc = jnp.maximum(D0C * 1e6,
                          ((rc / (AM_R * pp.Nt_c)) ** c.obmr) * 1e6)
        lamc = (pp.Nt_c * AM_R * c.ccg[1] * c.ocg1 / rc) ** c.obmr
        mvd_c = jnp.where(L_qc, (3.0 + c.mu_c + 0.672) / lamc, D0C)
        Dc_g = ((c.ccg[2] * c.ocg2) ** c.obmr / lamc) * 1e6
    # mean snow size for the snow-cloud collection efficiency index
    # (mp_thompson.f90:1705-1710)
    xDs = jnp.where(L_qs, smoc / jnp.maximum(smob, R1), 0.0)

    P.update(
        t1d=t1d, temp=temp, tempc=tempc, qv=qv, pres=pres, rho=rho,
        rhof=rhof, rhof2=rhof2, diffu=diffu, visco=visco, ocp=ocp,
        vsc2=vsc2, lvap=lvap, tcond=tcond, qvs=qvs, delQvs=delQvs,
        qvsi=qvsi, ssatw=ssatw, ssati=ssati,
        L_qc=L_qc, qc1d=qc1d, rc=rc,
        L_qi=L_qi, qi1d=qi1d, ni1d=ni1d, ri=ri, ni=ni,
        L_qr=L_qr, qr1d=qr1d, nr1d=nr1d, rr=rr, nr=nr, mvd_r=mvd_r,
        L_qs=L_qs, qs1d=qs1d, rs=rs, L_qg=L_qg, qg1d=qg1d, rg=rg,
        smob=smob, smo2=smo2, smo0=smo0, smo1=smo1, smoc=smoc, smod=smod,
        smoe=smoe, smof=smof, ilamg=ilamg, N0_g=N0_g, ilamr=ilamr,
        N0_r=N0_r, zero=zero, xDc=xDc, mvd_c=mvd_c, Dc_g=Dc_g, xDs=xDs,
        qv1d=qv1d, exner=exner)
    return P


def _small_indices(P, c):
    """Bin indices for the small 2D tables (collision efficiencies,
    cloud-water freezing, ice autoconversion/deposition)."""
    rc, ri, ni, tempc = P["rc"], P["ri"], P["ni"], P["tempc"]
    idx_tc = jnp.clip(_nint(-tempc), 1, 45) - 1
    idx_c = jnp.where(rc > tt.r_c[0], _mantissa_idx(rc, c.nic2, NTB_C), 0)
    idx_i = jnp.where(ri > tt.r_i[0], _mantissa_idx(ri, c.nii2, NTB_I), 0)
    idx_i1 = jnp.where(ni > tt.Nt_i[0],
                       _mantissa_idx(ni, c.nii3, NTB_I1), 0)
    # collision-efficiency bins (rain/cloud, snow/cloud)
    idx_efr = jnp.clip(
        (NBR * jnp.log(P["mvd_r"] / tt.D0R)
         / np.log(float(c.Dr[-1] / c.Dr[0]))).astype(jnp.int32),
        0, NBR - 1)
    idx_efc = jnp.clip((P["mvd_c"] * 1e6).astype(jnp.int32) - 1, 0, NBC - 1)
    idx_efs = jnp.clip(
        (NBS * jnp.log(jnp.maximum(P["xDs"], D0S) / tt.D0S)
         / np.log(float(c.Ds[-1] / c.Ds[0]))).astype(jnp.int32), 0, NBS - 1)
    return dict(idx_tc=idx_tc, idx_c=idx_c, idx_i=idx_i, idx_i1=idx_i1,
                idx_efr=idx_efr, idx_efc=idx_efc, idx_efs=idx_efs)


def _index_block(P, c):
    """Lookup-table bin indices (mp_thompson.f90:1560-1736): decimal
    mantissa bins for the mixing-ratio tables, temperature bins, and the
    log-spaced collision-efficiency bins. Consumed by _gather_all."""
    rr, nr = P["rr"], P["nr"]
    rs, rg, tempc = P["rs"], P["rg"], P["tempc"]
    ilamr, ilamg = P["ilamr"], P["ilamg"]

    idx_t_raw = jnp.trunc((tempc - 2.5) / 5.0).astype(jnp.int32) - 1
    idx_t = jnp.clip(jnp.maximum(1, -idx_t_raw), 1, NTB_T) - 1
    has_r = rr > tt.r_r[0]
    idx_r = jnp.where(has_r, _mantissa_idx(rr, c.nir2, NTB_R), 0)
    lam_exp_r = (1.0 / ilamr) * (c.crg[2] * c.org2 * c.org1) ** BM_R
    N0_exp_r = c.org1 * rr / AM_R * lam_exp_r ** c.cre[0]
    idx_r1 = jnp.where(has_r, _mantissa_idx(N0_exp_r, c.nir3, NTB_R1),
                       NTB_R1 - 1)
    idx_s = jnp.where(rs > tt.r_s[0], _mantissa_idx(rs, c.nis2, NTB_S), 0)
    has_g = rg > tt.r_g[0]
    idx_g = jnp.where(has_g, _mantissa_idx(rg, c.nig2, NTB_G), 0)
    lam_exp_g = (1.0 / ilamg) * (c.cgg[2] * c.ogg2 * c.ogg1) ** BM_G
    N0_exp_g = c.ogg1 * rg / c.am_g * lam_exp_g ** c.cge[0]
    idx_g1 = jnp.where(has_g, _mantissa_idx(N0_exp_g, c.nig3, NTB_G1),
                       NTB_G1 - 1)

    return dict(idx_t=idx_t, idx_r=idx_r, idx_r1=idx_r1, idx_s=idx_s,
                idx_g=idx_g, idx_g1=idx_g1, **_small_indices(P, c))


def _gated_take(pred, T, names, idxs, dtype, stk):
    """_take_tables behind a whole-domain presence predicate: when no
    cell can consume a group's values (every rate that reads them is
    masked off everywhere), skip the gather entirely. This is the
    reference's per-column L_qr/L_qg/temperature guards
    (mp_thompson.f90:1764,1789) lifted to domain granularity; e.g. the
    ideal-ridge regime produces zero graupel, so the rain-graupel
    collection gather never needs to run."""
    def do(_):
        return _take_tables(T, names, idxs, stk)

    def zero(_):
        tab = T[stk]
        return jnp.zeros((tab.shape[0],) + idxs[0].shape,
                         jnp.asarray(tab).dtype)

    stkv = jax.lax.cond(pred, do, zero, None)
    vals_f = stkv.astype(dtype)
    return {n: vals_f[i] for i, n in enumerate(names)}


def _gather_all(T, I, dtype, P=None):
    """All table lookups (between the index block and the core): three
    stacked flat gathers for the 4D/3D tables and exact one-hot
    contractions for the small 2D tables. Returns {table_name:
    looked-up field}. ``P`` (the prep dict) enables the whole-domain gather gates (_gated_take):
    racs needs rain+snow coexisting (rs_on, _core_block:819), racg
    rain+graupel (rg_on, :850), qrfz supercooled rain (cold & frz_tab,
    :862-875; the tempc < 0.5 margin makes the predicate a strict
    superset of cold = temp < T_0)."""
    if P is not None:
        rr, rs, rg = P["rr"], P["rs"], P["rg"]
        any_rs = jnp.any((rr >= tt.r_r[0]) & (rs >= tt.r_s[0]))
        any_rg = jnp.any((rr >= tt.r_r[0]) & (rg >= tt.r_g[0]))
        any_rfz = jnp.any((rr > tt.r_r[0]) & (P["tempc"] < 0.5))
    else:
        any_rs = any_rg = any_rfz = jnp.bool_(True)
    RS = _gated_take(
        any_rs, T, _RACS_NAMES,
        (I["idx_s"], I["idx_t"], I["idx_r1"], I["idx_r"]),
        dtype, "_stk_racs")
    GG = _gated_take(
        any_rg, T, _RACG_NAMES,
        (I["idx_g1"], I["idx_g"], I["idx_r1"], I["idx_r"]),
        dtype, "_stk_racg")
    QF = _gated_take(
        any_rfz, T, _QRFZ_NAMES,
        (I["idx_r"], I["idx_r1"], I["idx_tc"]),
        dtype, "_stk_qrfz")
    G = {**RS, **GG, **QF}
    G.update(_onehot_tables(T, ("t_Efrw",), I["idx_efr"], I["idx_efc"],
                            dtype, "_stk_efrw"))
    G.update(_onehot_tables(T, ("t_Efsw",), I["idx_efs"], I["idx_efc"],
                            dtype, "_stk_efsw"))
    G.update(_onehot_tables(T, _QCFZ_NAMES, I["idx_c"], I["idx_tc"],
                            dtype, "_stk_qcfz"))
    G.update(_onehot_tables(T, _IAUS_NAMES, I["idx_i"], I["idx_i1"],
                            dtype, "_stk_iaus"))
    return G


def _core_block(P, idx_i, G, DT, c, pp, tnc_wev_flat=None):
    """Process rates, conservation scalings, tendencies, the TAU+1
    update, cloud condensation/evaporation, rain evaporation and terminal
    velocities (mp_thompson.f90:1496-2655) — everything between the table
    lookups and sedimentation. Pure elementwise math on the grid. ``G``
    maps table names to pre-gathered values; ``idx_i`` is the ice bin
    index (the one table index the rate logic itself consumes, for the
    large-ice autoconversion branch)."""
    aer = "ncr" in P
    odt = 1.0 / DT
    odts = odt
    dtype = P["t1d"].dtype

    (t1d, temp, tempc, qv, pres, rho, rhof, rhof2, diffu, visco, ocp,
     vsc2, lvap, tcond, qvs, delQvs, qvsi, ssatw, ssati) = (
        P["t1d"], P["temp"], P["tempc"], P["qv"], P["pres"], P["rho"],
        P["rhof"], P["rhof2"], P["diffu"], P["visco"], P["ocp"], P["vsc2"],
        P["lvap"], P["tcond"], P["qvs"], P["delQvs"], P["qvsi"],
        P["ssatw"], P["ssati"])
    (L_qc, qc1d, rc, L_qi, qi1d, ni1d, ri, ni, L_qr, qr1d, nr1d, rr, nr,
     mvd_r, L_qs, qs1d, rs, L_qg, qg1d, rg) = (
        P["L_qc"], P["qc1d"], P["rc"], P["L_qi"], P["qi1d"], P["ni1d"],
        P["ri"], P["ni"], P["L_qr"], P["qr1d"], P["nr1d"], P["rr"],
        P["nr"], P["mvd_r"], P["L_qs"], P["qs1d"], P["rs"], P["L_qg"],
        P["qg1d"], P["rg"])
    (smob, smo2, smo0, smo1, smoc, smod, smoe, smof, ilamg, N0_g, ilamr,
     N0_r, zero, qv1d) = (
        P["smob"], P["smo2"], P["smo0"], P["smo1"], P["smoc"], P["smod"],
        P["smoe"], P["smof"], P["ilamg"], P["N0_g"], P["ilamr"],
        P["N0_r"], P["zero"], P["qv1d"])
    if aer:
        nc1d, ncr, nwfa, nifa, w1d, nwfa1d = (
            P["nc1d"], P["ncr"], P["nwfa"], P["nifa"], P["w1d"],
            P["nwfa1d"])

    # ---- warm-rain processes (mp_thompson.f90:1496-1545) ---------------
    Ef_rr = 2.0 - jnp.exp(jnp.minimum(2300.0 * (mvd_r - 1600.0e-6), 50.0))
    pnr_rcr = jnp.where(L_qr & (mvd_r > D0R), Ef_rr * 4. * nr * rr, 0.0)

    # cloud PSD parameters computed in _prep_block (constant-Nt_c or
    # prognostic-nc form)
    xDc, mvd_c, Dc_g = P["xDc"], P["mvd_c"], P["Dc_g"]
    if aer:
        nu_cw = P["nu_cw"]
    Dc_b = jnp.maximum(xDc ** 3 * Dc_g ** 3 - xDc ** 6, 0.0) ** (1.0 / 6.0)
    zeta1 = jnp.maximum(6.25e-6 * xDc * Dc_b ** 3 - 0.4, 0.0)
    zeta = 0.027 * rc * zeta1
    taud = jnp.maximum(0.5 * Dc_b - 7.5, 0.0) + R1
    tau = 3.72 / (rc * taud)
    wau_on = L_qc & (rc > 0.01e-3)
    prr_wau = jnp.where(wau_on, jnp.minimum(rc * odts, zeta / tau), 0.0)
    if aer:
        pnr_wau = prr_wau / (AM_R * nu_cw * D0R ** 3)
        # droplet-number loss to autoconversion (Qc2M,
        # mp_thompson_aer.f90:1978-1979)
        pnc_wau = jnp.where(wau_on,
                            jnp.minimum(ncr * odts,
                                        prr_wau / (AM_R * mvd_c ** 3)), 0.0)
    else:
        pnr_wau = prr_wau / (AM_R * c.mu_c * D0R ** 3)

    # rain collecting cloud water (collision efficiency looked up by G)
    Ef_rw = G["t_Efrw"]
    rcw_on = L_qc & L_qr & (mvd_r > D0R) & (mvd_c > D0C)
    prr_rcw = jnp.where(
        rcw_on,
        jnp.minimum(rc * odts,
                    rhof * c.t1_qr_qc * Ef_rw * rc * N0_r
                    * ((1.0 / ilamr + FV_R) ** (-c.cre[8]))), 0.0)
    if aer:
        # droplet number collected by rain (Qc2M,
        # mp_thompson_aer.f90:1991-1993)
        pnc_rcw = jnp.where(
            rcw_on,
            jnp.minimum(ncr * odts,
                        rhof * c.t1_qr_qc * Ef_rw * ncr * N0_r
                        * ((1.0 / ilamr + FV_R) ** (-c.cre[8]))), 0.0)
        # wet scavenging of aerosols by rain (mp_thompson_aer.f90:1997-2008)
        rca_on = L_qr & (mvd_r > D0R)
        vt_mvd = tt.vr_poly_jnp(mvd_r)
        Ef_ra_w = _eff_aero(mvd_r, 0.04e-6, visco, rho, temp, vt_mvd)
        pna_rca = jnp.where(
            rca_on,
            jnp.minimum(nwfa * odts,
                        rhof * c.t1_qr_qc * Ef_ra_w * nwfa * N0_r
                        * ((1.0 / ilamr + FV_R) ** (-c.cre[8]))), 0.0)
        Ef_ra_d = _eff_aero(mvd_r, 0.8e-6, visco, rho, temp, vt_mvd)
        pnd_rcd = jnp.where(
            rca_on,
            jnp.minimum(nifa * odts,
                        rhof * c.t1_qr_qc * Ef_ra_d * nifa * N0_r
                        * ((1.0 / ilamr + FV_R) ** (-c.cre[8]))), 0.0)

    # (table bin indices live in _index_block; every looked-up value
    # arrives through G)

    # deposition/sublimation prefactor (Srivastava & Coen 1992)
    otemp = 1.0 / temp
    rvs = rho * qvsi
    rvs_p = rvs * otemp * (LSUB * otemp * ORV - 1.)
    rvs_pp = rvs * (otemp * (LSUB * otemp * ORV - 1.)
                    * otemp * (LSUB * otemp * ORV - 1.)
                    + (-2. * LSUB * otemp ** 3 * ORV) + otemp * otemp)
    gamsc = LSUB * diffu / tcond * rvs_p
    alphsc = jnp.maximum(1e-9, 0.5 * (gamsc / (1. + gamsc)) ** 2
                         * rvs_pp / rvs_p * rvs / rvs_p)
    xsat = jnp.where(jnp.abs(ssati) < 1e-9, 0.0, ssati)
    t1_subl = 4. * PI * (1.0 - alphsc * xsat + 2. * alphsc ** 2 * xsat ** 2
                         - 5. * alphsc ** 3 * xsat ** 3) / (1. + gamsc)

    # snow/graupel collecting cloud water (mp_thompson.f90:1705-1736)
    xDs = P["xDs"]
    Ef_sw = G["t_Efsw"]
    scw_on = L_qc & (mvd_c > D0C) & (xDs > D0S)
    prs_scw = jnp.where(scw_on, rhof * c.t1_qs_qc * Ef_sw * rc * smoe, 0.0)

    xDg = (BM_G + c.mu_g + 1.) * ilamg
    vtg_c = rhof * pp.av_g * c.cgg[5] * c.ogg3 * ilamg ** pp.bv_g
    stoke_g = mvd_c * mvd_c * vtg_c * RHO_W / (9. * visco * xDg)
    Ef_gw = jnp.where(stoke_g >= 0.4,
                      jnp.where(stoke_g <= 10.0,
                                0.55 * jnp.log10(2.51 * stoke_g), 0.77),
                      0.0)
    gcw_on = (L_qc & (mvd_c > D0C) & (rg >= tt.r_g[0]) & (xDg > D0G))
    prg_gcw = jnp.where(gcw_on, rhof * c.t1_qg_qc * Ef_gw * rc * N0_g
                        * ilamg ** c.cge[8], 0.0)
    if aer:
        # droplet number collected by snow/graupel (Qc2M,
        # mp_thompson_aer.f90:2177-2198)
        pnc_scw = jnp.where(scw_on,
                            jnp.minimum(ncr * odts, rhof * c.t1_qs_qc
                                        * Ef_sw * ncr * smoe), 0.0)
        pnc_gcw = jnp.where(gcw_on,
                            jnp.minimum(ncr * odts, rhof * c.t1_qg_qc
                                        * Ef_gw * ncr * N0_g
                                        * ilamg ** c.cge[8]), 0.0)
        # wet scavenging by snow and graupel (mp_thompson_aer.f90:2203-2226)
        sca_on = rs > tt.r_s[0]
        xDs_a = smoc / jnp.maximum(smob, R1)
        vts_a = pp.av_s * xDs_a ** pp.bv_s
        pna_sca = jnp.where(
            sca_on, jnp.minimum(nwfa * odts, rhof * c.t1_qs_qc
                                * _eff_aero(xDs_a, 0.04e-6, visco, rho,
                                            temp, vts_a) * nwfa * smoe), 0.0)
        pnd_scd = jnp.where(
            sca_on, jnp.minimum(nifa * odts, rhof * c.t1_qs_qc
                                * _eff_aero(xDs_a, 0.8e-6, visco, rho,
                                            temp, vts_a) * nifa * smoe), 0.0)
        gca_on = rg > tt.r_g[0]
        vtg_a = pp.av_g * xDg ** pp.bv_g
        pna_gca = jnp.where(
            gca_on, jnp.minimum(nwfa * odts, rhof * c.t1_qg_qc
                                * _eff_aero(xDg, 0.04e-6, visco, rho,
                                            temp, vtg_a) * nwfa * N0_g
                                * ilamg ** c.cge[8]), 0.0)
        pnd_gcd = jnp.where(
            gca_on, jnp.minimum(nifa * odts, rhof * c.t1_qg_qc
                                * _eff_aero(xDg, 0.8e-6, visco, rho,
                                            temp, vtg_a) * nifa * N0_g
                                * ilamg ** c.cge[8]), 0.0)

    # ---- rain collecting snow / graupel via lookup tables --------------
    def gat(name):
        return G[name]

    gat_g = gat

    rs_on = (rr >= tt.r_r[0]) & (rs >= tt.r_s[0])
    cold = temp < T_0
    racs1 = gat("tcs_racs1")
    racs2 = gat("tcs_racs2")
    mracs1 = gat("tmr_racs1")
    mracs2 = gat("tmr_racs2")
    sacr1 = gat("tcr_sacr1")
    sacr2 = gat("tcr_sacr2")
    msacr1 = gat("tms_sacr1")
    msacr2 = gat("tms_sacr2")
    nracs1 = gat("tnr_racs1")
    nracs2 = gat("tnr_racs2")
    nsacr1 = gat("tnr_sacr1")
    nsacr2 = gat("tnr_sacr2")

    prr_rcs_c = jnp.maximum(-rr * odts,
                            -(mracs2 + sacr2 + mracs1 + sacr1))
    prs_rcs_c = jnp.maximum(-rs * odts, mracs2 + sacr2 - racs1 - msacr1)
    prg_rcs_c = jnp.minimum((rr + rs) * odts,
                            mracs1 + sacr1 + racs1 + msacr1)
    pnr_rcs_c = nracs1 + nracs2 + nsacr1 + nsacr2
    prs_rcs_w = jnp.maximum(-rs * odts, -racs1 - msacr1 + mracs2 + sacr2)
    prr_rcs_w = -prs_rcs_w
    pnr_rcs_w = nracs2 + nsacr2
    prr_rcs = jnp.where(rs_on, jnp.where(cold, prr_rcs_c, prr_rcs_w), 0.0)
    prs_rcs = jnp.where(rs_on, jnp.where(cold, prs_rcs_c, prs_rcs_w), 0.0)
    prg_rcs = jnp.where(rs_on & cold, prg_rcs_c, 0.0)
    pnr_rcs = jnp.where(rs_on, jnp.minimum(
        nr * odts, jnp.where(cold, pnr_rcs_c, pnr_rcs_w)), 0.0)

    rg_on = (rr >= tt.r_r[0]) & (rg >= tt.r_g[0])
    prg_rcg_c = jnp.minimum(rr * odts, gat_g("tmr_racg") + gat_g("tcr_gacr"))
    pnr_rcg_c = jnp.minimum(nr * odts,
                            gat_g("tnr_racg") + gat_g("tnr_gacr"))
    prr_rcg_w = jnp.minimum(rg * odts, gat_g("tcg_racg"))
    prg_rcg = jnp.where(rg_on, jnp.where(cold, prg_rcg_c, -prr_rcg_w), 0.0)
    prr_rcg = jnp.where(rg_on, jnp.where(cold, -prg_rcg_c, prr_rcg_w), 0.0)
    pnr_rcg = jnp.where(rg_on & cold, pnr_rcg_c, 0.0)

    # ---- processes below 0C (mp_thompson.f90:1789-1955) ----------------
    rate_max_i = (qv - qvsi) * rho * odts * 0.999

    frz_tab = (rr > tt.r_r[0])
    QF = G
    prg_rfz = jnp.where(cold & frz_tab, QF["tpg_qrfz"] * odts, 0.0)
    pri_rfz = jnp.where(
        cold, jnp.where(frz_tab, QF["tpi_qrfz"] * odts,
                        jnp.where((rr > R1) & (temp < HGFR),
                                  rr * odts, 0.0)), 0.0)
    pni_rfz = jnp.where(
        cold, jnp.where(frz_tab, QF["tni_qrfz"] * odts,
                        jnp.where((rr > R1) & (temp < HGFR),
                                  nr * odts, 0.0)), 0.0)
    pnr_rfz = jnp.where(
        cold & frz_tab,
        jnp.minimum(nr * odts, QF["tnr_qrfz"] * odts),
        jnp.where(cold & (rr > R1) & (temp < HGFR), nr * odts, 0.0))

    wfz_tab = rc > tt.r_c[0]
    CF = G
    pri_wfz = jnp.where(
        cold, jnp.where(wfz_tab,
                        jnp.minimum(rc * odts, CF["tpi_qcfz"] * odts),
                        jnp.where((rc > R1) & (temp < HGFR),
                                  rc * odts, 0.0)), 0.0)
    nc_for_wfz = ncr if aer else pp.Nt_c
    pni_wfz = jnp.where(
        cold & wfz_tab,
        jnp.minimum(jnp.minimum(nc_for_wfz * odts,
                                pri_wfz / (2. * XM0I)),
                    CF["tni_qcfz"] * odts), 0.0)

    # ice nucleation: Cooper (1986), or DeMott (2010) from nifa when
    # aerosol-aware (dustyIce branch, mp_thompson_aer.f90:2355-2366)
    if aer:
        nuc_on = cold & ((ssati >= 0.25)
                         | ((ssatw > EPS) & (temp < 253.15)))
        xnc = _ice_demott(tempc, rho, nifa)
    else:
        nuc_on = cold & ((ssati >= 0.25)
                         | ((ssatw > EPS) & (temp < 261.15)))
        xnc = jnp.minimum(250e3, pp.TNO * jnp.exp(ATO * (T_0 - temp)))
    xni_c = ni + (pni_rfz + pni_wfz) * DT
    pni_inu = jnp.where(nuc_on, jnp.maximum(0.0, xnc - xni_c) * odts, 0.0)
    pri_inu = jnp.where(nuc_on,
                        jnp.minimum(rate_max_i, XM0I * pni_inu), 0.0)
    pni_inu = pri_inu / XM0I

    if aer:
        # homogeneous freezing of deliquesced aerosols (Koop et al. 2001;
        # homogIce branch, mp_thompson_aer.f90:2369-2377)
        xni_k = smo0 + ni + (pni_rfz + pni_wfz + pni_inu) * DT
        koop_on = (xni_k <= 500e3) & (temp < 238.0) & (ssati >= 0.4)
        xnc_k = _ice_koop(temp, qv, qvs, nwfa, DT)
        pni_iha = jnp.where(koop_on, xnc_k * odts, 0.0)
        pri_iha = jnp.where(koop_on,
                            jnp.minimum(rate_max_i, XM0I * 0.1 * pni_iha),
                            0.0)
        pni_iha = pri_iha / (XM0I * 0.1)
    else:
        pni_iha = zero
        pri_iha = zero

    # ice deposition / sublimation
    lami = (AM_I * c.cig[1] * c.oig1 * ni / ri) ** c.obmi
    ilami = 1.0 / lami
    xDi = jnp.maximum(jnp.asarray(c.D0i, dtype),
                      (BM_I + c.mu_i + 1.0) * ilami)
    xmi = AM_I * xDi ** BM_I
    oxmi = 1.0 / xmi
    ide_raw = C_CUBE * t1_subl * diffu * ssati * rvs \
        * c.oig1 * c.cig[4] * ni * ilami
    II = G
    tpi_ide = II["tpi_ide"]
    ide_on = cold & L_qi
    pri_ide_neg = jnp.maximum(jnp.maximum(-ri * odts, ide_raw), rate_max_i)
    pni_ide = jnp.where(ide_on & (ide_raw < 0.0),
                        jnp.maximum(-ni * odts, pri_ide_neg * oxmi), 0.0)
    pri_ide_pos = jnp.minimum(ide_raw, rate_max_i)
    prs_ide = jnp.where(ide_on & (ide_raw >= 0.0),
                        (1.0 - tpi_ide) * pri_ide_pos, 0.0)
    pri_ide = jnp.where(ide_on,
                        jnp.where(ide_raw < 0.0, pri_ide_neg,
                                  tpi_ide * pri_ide_pos), 0.0)

    # ice -> snow autoconversion via bin table
    iau_big = (idx_i == NTB_I - 1) | (xDi > 5.0 * D0S)
    iau_none = xDi < 0.1 * D0S
    prs_iau = jnp.where(
        ide_on,
        jnp.where(iau_big, ri * .99 * odts,
                  jnp.where(iau_none, 0.0,
                            jnp.minimum(ri * .99 * odts,
                                        II["tps_iaus"] * odts))), 0.0)
    pni_iau = jnp.where(
        ide_on,
        jnp.where(iau_big, ni * .95 * odts,
                  jnp.where(iau_none, 0.0,
                            jnp.minimum(ni * .95 * odts,
                                        II["tni_iaus"] * odts))), 0.0)

    # snow deposition / sublimation
    C_snow = jnp.clip(pp.C_sqrd + (tempc + 15.) * (pp.C_cubes - pp.C_sqrd)
                      / (-30. + 15.), min(pp.C_sqrd, pp.C_cubes),
                      max(pp.C_sqrd, pp.C_cubes))
    sde_raw = C_snow * t1_subl * diffu * ssati * rvs \
        * (c.t1_qs_sd * smo1 + c.t2_qs_sd * rhof2 * vsc2 * smof)
    prs_sde_c = jnp.where(sde_raw < 0.0,
                          jnp.maximum(jnp.maximum(-rs * odts, sde_raw),
                                      rate_max_i),
                          jnp.minimum(sde_raw, rate_max_i))
    prs_sde = jnp.where(cold & L_qs, prs_sde_c, 0.0)

    gde_raw = C_CUBE * t1_subl * diffu * ssati * rvs \
        * N0_g * (c.t1_qg_sd * ilamg ** c.cge[9]
                  + c.t2_qg_sd * vsc2 * rhof2 * ilamg ** c.cge[10])
    prg_gde_c = jnp.where(gde_raw < 0.0,
                          jnp.maximum(jnp.maximum(-rg * odts, gde_raw),
                                      rate_max_i),
                          jnp.minimum(gde_raw, rate_max_i))
    prg_gde = jnp.where(cold & L_qg & (ssati < -EPS), prg_gde_c, 0.0)

    # snow/rain collecting cloud ice
    sci_on = cold & L_qi & (rs >= tt.r_s[0])
    prs_sci = jnp.where(sci_on, c.t1_qs_qi * rhof * pp.Ef_si * ri * smoe,
                        0.0)
    pni_sci = prs_sci * oxmi
    rci_on = cold & L_qi & (rr >= tt.r_r[0]) & (mvd_r > 4. * xDi)
    lamr_c = 1.0 / ilamr
    pri_rci = jnp.where(rci_on, rhof * c.t1_qr_qi * pp.Ef_ri * ri * N0_r
                        * ((lamr_c + FV_R) ** (-c.cre[8])), 0.0)
    pnr_rci = jnp.where(rci_on, rhof * c.t1_qr_qi * pp.Ef_ri * ni * N0_r
                        * ((lamr_c + FV_R) ** (-c.cre[8])), 0.0)
    pni_rci = pri_rci * oxmi
    prr_rci = jnp.where(rci_on,
                        jnp.minimum(rr * odts,
                                    rhof * c.t2_qr_qi * pp.Ef_ri * ni * N0_r
                                    * ((lamr_c + FV_R) ** (-c.cre[7]))), 0.0)
    prg_rci = pri_rci + prr_rci

    # Hallet-Mossop rime splintering
    tf = jnp.where((tempc >= -5.0) & (tempc < -3.0), 0.5 * (-3.0 - tempc),
                   jnp.where((tempc > -8.0) & (tempc < -5.0),
                             (8.0 + tempc) / 3.0, 0.0))
    ihm_on = cold & (prg_gcw > EPS) & (tempc > -8.0)
    pni_ihm = jnp.where(ihm_on, 3.5e8 * tf * prg_gcw, 0.0)
    pri_ihm = XM0I * pni_ihm
    denom_hm = jnp.maximum(prs_scw + prg_gcw, 1e-30)
    prs_ihm = prs_scw / denom_hm * pri_ihm
    prg_ihm = prg_gcw / denom_hm * pri_ihm

    # rimed snow -> graupel conversion + fallspeed boost
    conv_on = cold & (prs_scw > 5.0 * prs_sde) & (prs_sde > EPS)
    r_frac = jnp.minimum(30.0, prs_scw / jnp.maximum(prs_sde, 1e-30))
    g_frac = jnp.minimum(0.75, 0.05 + (r_frac - 5.) * .028)
    vts_boost = jnp.where(cold,
                          jnp.where(conv_on,
                                    jnp.minimum(1.5, 1.1 + (r_frac - 5.)
                                                * .016), 1.0), 1.5)
    prg_scw = jnp.where(conv_on, g_frac * prs_scw, 0.0)
    prs_scw = jnp.where(conv_on, (1. - g_frac) * prs_scw, prs_scw)

    # ---- melting (T >= 0C; mp_thompson.f90:1957-2010) ------------------
    warm = ~cold
    sml_raw = (tempc * tcond - LVAP0 * diffu * delQvs) \
        * (c.t1_qs_me * smo1 + c.t2_qs_me * rhof2 * vsc2 * smof)
    sml = sml_raw + 4218. * OLFUS * tempc * (prr_rcs + prs_scw)
    prr_sml = jnp.where(warm & L_qs,
                        jnp.minimum(rs * odts, jnp.maximum(0.0, sml)), 0.0)
    pnr_sml = jnp.where(warm & L_qs,
                        jnp.minimum(smo0 * odts,
                                    smo0 / jnp.maximum(rs, R1) * prr_sml
                                    * 10.0 ** (-0.75 * tempc)), 0.0)
    pnr_sml = jnp.where((tempc > 3.5) | (rs < 0.005e-3), 0.0, pnr_sml)

    sde_w = pp.C_cubes * t1_subl * diffu * ssati * rvs \
        * (c.t1_qs_sd * smo1 + c.t2_qs_sd * rhof2 * vsc2 * smof)
    prs_sde = jnp.where(warm & L_qs & (ssati < 0.0),
                        jnp.maximum(-rs * odts, sde_w), prs_sde)

    gml_raw = (tempc * tcond - LVAP0 * diffu * delQvs) \
        * N0_g * (c.t1_qg_me * ilamg ** c.cge[9]
                  + c.t2_qg_me * rhof2 * vsc2 * ilamg ** c.cge[10])
    prr_gml = jnp.where(warm & L_qg,
                        jnp.minimum(rg * odts, jnp.maximum(0.0, gml_raw)),
                        0.0)
    pnr_gml = jnp.where(warm & L_qg,
                        N0_g * c.cgg[1] * ilamg ** c.cge[1]
                        / jnp.maximum(rg, R1) * prr_gml
                        * 10.0 ** (-1.5 * tempc), 0.0)
    pnr_gml = jnp.where((tempc > 7.5) | (rg < 0.005e-3), 0.0, pnr_gml)
    prg_gde = jnp.where(warm & L_qg & (ssati < 0.0),
                        jnp.maximum(-rg * odts, gde_raw), prg_gde)

    # dt>120s: route collected cloud water to rain above freezing
    if_dt = DT > 120.0
    prr_rcw = prr_rcw + jnp.where(warm & if_dt, prs_scw + prg_gcw, 0.0)
    prs_scw = jnp.where(warm & if_dt, 0.0, prs_scw)
    prg_gcw = jnp.where(warm & if_dt, 0.0, prg_gcw)

    # ---- conservation scalings (mp_thompson.f90:2016-2105) -------------
    sump = pri_inu + pri_ide + prs_ide + prs_sde + prg_gde
    # NOTE reference quirk preserved: this conservation cap OMITS rho
    # (mp_thompson.f90:2022, `(qv-qvsi)*odts*0.999`) even though sump is
    # density-weighted and the per-process caps above include rho
    # (:1791) — inconsistent units in the reference, reproduced exactly.
    # (Caught by the cold transcription oracle: with rho included, the
    # sublimation limiter engaged at the wrong threshold off-surface.)
    rate_max = (qv - qvsi) * odts * 0.999
    need = ((sump > EPS) & (sump > rate_max)) \
        | ((sump < -EPS) & (sump < rate_max))
    rat = jnp.where(need, rate_max / jnp.where(sump == 0, 1.0, sump), 1.0)
    pri_inu, pri_ide, pni_ide = pri_inu * rat, pri_ide * rat, pni_ide * rat
    prs_ide, prs_sde, prg_gde = prs_ide * rat, prs_sde * rat, prg_gde * rat

    sump = -prr_wau - pri_wfz - prr_rcw - prs_scw - prg_scw - prg_gcw
    rate_max = -rc * odts
    rat = jnp.where((sump < rate_max) & L_qc,
                    rate_max / jnp.where(sump == 0, 1.0, sump), 1.0)
    prr_wau, pri_wfz, prr_rcw = prr_wau * rat, pri_wfz * rat, prr_rcw * rat
    prs_scw, prg_scw, prg_gcw = prs_scw * rat, prg_scw * rat, prg_gcw * rat

    sump = pri_ide - prs_iau - prs_sci - pri_rci
    rate_max = -ri * odts
    rat = jnp.where((sump < rate_max) & L_qi,
                    rate_max / jnp.where(sump == 0, 1.0, sump), 1.0)
    pri_ide, prs_iau = pri_ide * rat, prs_iau * rat
    prs_sci, pri_rci = prs_sci * rat, pri_rci * rat

    sump = -prg_rfz - pri_rfz - prr_rci + prr_rcs + prr_rcg
    rate_max = -rr * odts
    rat = jnp.where((sump < rate_max) & L_qr,
                    rate_max / jnp.where(sump == 0, 1.0, sump), 1.0)
    prg_rfz, pri_rfz, prr_rci = prg_rfz * rat, pri_rfz * rat, prr_rci * rat
    prr_rcs, prr_rcg = prr_rcs * rat, prr_rcg * rat

    sump = prs_sde - prs_ihm - prr_sml + prs_rcs
    rate_max = -rs * odts
    rat = jnp.where((sump < rate_max) & L_qs,
                    rate_max / jnp.where(sump == 0, 1.0, sump), 1.0)
    prs_sde, prs_ihm = prs_sde * rat, prs_ihm * rat
    prr_sml, prs_rcs = prr_sml * rat, prs_rcs * rat

    sump = prg_gde - prg_ihm - prr_gml + prg_rcg
    rate_max = -rg * odts
    rat = jnp.where((sump < rate_max) & L_qg,
                    rate_max / jnp.where(sump == 0, 1.0, sump), 1.0)
    prg_gde, prg_ihm = prg_gde * rat, prg_ihm * rat
    prr_gml, prg_rcg = prr_gml * rat, prg_rcg * rat

    pri_ihm = prs_ihm + prg_ihm
    ratio = jnp.minimum(jnp.abs(prr_rcg), jnp.abs(prg_rcg))
    prr_rcg = ratio * jnp.sign(prr_rcg)
    prg_rcg = -prr_rcg
    ratio = jnp.minimum(jnp.abs(prr_rcs), jnp.abs(prs_rcs))
    prr_rcs = jnp.where(warm, ratio * jnp.sign(prr_rcs), prr_rcs)
    prs_rcs = jnp.where(warm, -prr_rcs, prs_rcs)

    # ---- tendencies (mp_thompson.f90:2110-2240) ------------------------
    orho = 1.0 / rho
    lfus2 = LSUB - lvap
    qvten = (-pri_inu - pri_iha - pri_ide - prs_ide - prs_sde
             - prg_gde) * orho
    qcten = (-prr_wau - pri_wfz - prr_rcw - prs_scw - prg_scw
             - prg_gcw) * orho
    qiten = (pri_inu + pri_iha + pri_ihm + pri_wfz + pri_rfz + pri_ide
             - prs_iau - prs_sci - pri_rci) * orho
    niten = (pni_inu + pni_iha + pni_ihm + pni_wfz + pni_rfz + pni_ide
             - pni_iau - pni_sci - pni_rci) * orho

    if aer:
        # aerosol number tendencies: wet scavenging + nucleation sinks
        # (mp_thompson_aer.f90:2664-2674; dustyIce=.true.)
        nwfaten = -(pna_rca + pna_sca + pna_gca + pni_iha) * orho
        nifaten = -(pnd_rcd + pnd_scd + pnd_gcd + pni_inu) * orho
        # droplet number tendency + mass/number balance keeping the mean
        # size in [D0c, 2*D0r] and at most Nt_c_max drops
        # (mp_thompson_aer.f90:2687-2716)
        ncten = (-pnc_wau - pnc_rcw - pni_wfz - pnc_scw - pnc_gcw) * orho
        xrc_b = jnp.maximum(R1, (qc1d + qcten * DT) * rho)
        xnc_b = jnp.maximum(2.0, (nc1d + ncten * DT) * rho)
        nu_cb = _nu_c_jnp(xnc_b)
        g1b, _ = _g_ratios(nu_cb)
        lamc_b = (xnc_b * AM_R * g1b / rc) ** c.obmr
        xDc_b = (BM_R + nu_cb + 1.0) / lamc_b
        cce2b = BM_R + nu_cb.astype(jnp.float32) + 1.0
        lamc_cl = jnp.where(xDc_b < D0C, cce2b / D0C, cce2b / (D0R * 2.))
        xnc_cl = xrc_b / (AM_R * g1b) * lamc_cl ** BM_R
        ncten = jnp.where(
            xrc_b > R1,
            jnp.where((xDc_b < D0C) | (xDc_b > D0R * 2.),
                      (xnc_cl - nc1d * rho) * odts * orho, ncten),
            -nc1d * odts)
        xnc_b = jnp.maximum(0.0, (nc1d + ncten * DT) * rho)
        ncten = jnp.where(xnc_b > tt.NT_C_MAX,
                          (tt.NT_C_MAX - nc1d * rho) * odts * orho, ncten)

    # ice number/mass balance
    xri = jnp.maximum(R1, (qi1d + qiten * DT) * rho)
    xni = jnp.maximum(R2, (ni1d + niten * DT) * rho)
    lami = (AM_I * c.cig[1] * c.oig1 * xni / xri) ** c.obmi
    xDi = (BM_I + c.mu_i + 1.0) / lami
    xni_lo = jnp.minimum(250e3, c.cig[0] * c.oig2 * xri / AM_I
                         * (c.cie[1] / 20e-6) ** BM_I)
    xni_hi = c.cig[0] * c.oig2 * xri / AM_I * (c.cie[1] / 300e-6) ** BM_I
    niten = jnp.where(xri > R1,
                      jnp.where(xDi < 20e-6,
                                (xni_lo - ni1d * rho) * odts * orho,
                                jnp.where(xDi > 300e-6,
                                          (xni_hi - ni1d * rho) * odts
                                          * orho, niten)),
                      -ni1d * odts)
    xni = jnp.maximum(0.0, (ni1d + niten * DT) * rho)
    niten = jnp.where(xni > 250e3, (250e3 - ni1d * rho) * odts * orho,
                      niten)

    qrten = (prr_wau + prr_rcw + prr_sml + prr_gml + prr_rcs + prr_rcg
             - prg_rfz - pri_rfz - prr_rci) * orho
    nrten = (pnr_wau + pnr_sml + pnr_gml
             - (pnr_rfz + pnr_rcr + pnr_rcg + pnr_rcs + pnr_rci)) * orho

    # rain number/mass balance
    xrr = jnp.maximum(R1, (qr1d + qrten * DT) * rho)
    xnr = jnp.maximum(R2, (nr1d + nrten * DT) * rho)
    lamr_b = (AM_R * c.crg[2] * c.org2 * xnr / xrr) ** c.obmr
    mvd_b = (3.0 + c.mu_r + 0.672) / lamr_b
    mvd_cl = jnp.clip(mvd_b, D0R * 0.75, 2.5e-3)
    xnr_cl = _rain_nr_from_mvd(xrr, mvd_cl, c)
    nrten = jnp.where(xrr > R1,
                      jnp.where(mvd_b != mvd_cl,
                                (xnr_cl - nr1d * rho) * odts * orho, nrten),
                      -nr1d * odts)
    qrten = jnp.where(xrr > R1, qrten, -qr1d * odts)

    qsten = (prs_iau + prs_sde + prs_sci + prs_scw + prs_rcs + prs_ide
             - prs_ihm - prr_sml) * orho
    qgten = (prg_scw + prg_rfz + prg_gde + prg_rcg + prg_gcw + prg_rci
             + prg_rcs - prg_ihm - prr_gml) * orho

    tten = jnp.where(
        cold,
        (LSUB * ocp * (pri_inu + pri_iha + pri_ide + prs_ide + prs_sde
                       + prg_gde)
         + lfus2 * ocp * (pri_wfz + pri_rfz + prg_rfz + prs_scw + prg_scw
                          + prg_gcw + prg_rcs + prs_rcs + prr_rci
                          + prg_rcg)) * orho,
        (LFUS * ocp * (-prr_sml - prr_gml - prr_rcg - prr_rcs)
         + LSUB * ocp * (prs_sde + prg_gde)) * orho)

    # ---- update to TAU+1 (mp_thompson.f90:2245-2330) -------------------
    temp = t1d + DT * tten
    qv = jnp.maximum(1e-10, qv1d + DT * qvten)
    rho, rhof, rhof2, diffu, visco, ocp, vsc2, lvap, tcond = \
        _thermo(temp, pres, qv)
    tempc = temp - 273.15
    otemp = 1.0 / temp
    qvs = rslf(pres, temp)
    ssatw = qv / qvs - 1.0
    ssatw = jnp.where(jnp.abs(ssatw) < EPS, 0.0, ssatw)
    lvt2 = lvap * lvap * ocp * ORV * otemp * otemp

    L_qc = (qc1d + qcten * DT) > R1
    rc = jnp.where(L_qc, (qc1d + qcten * DT) * rho, R1)
    L_qi = (qi1d + qiten * DT) > R1
    ri = jnp.where(L_qi, (qi1d + qiten * DT) * rho, R1)
    ni = jnp.where(L_qi, jnp.maximum(R2, (ni1d + niten * DT) * rho), R2)
    L_qr = (qr1d + qrten * DT) > R1
    rr = jnp.where(L_qr, (qr1d + qrten * DT) * rho, R1)
    nr = jnp.where(L_qr, jnp.maximum(R2, (nr1d + nrten * DT) * rho), R2)
    lamr_u = (AM_R * c.crg[2] * c.org2 * nr / rr) ** c.obmr
    mvd_u = (3.0 + c.mu_r + 0.672) / lamr_u
    mvd_ucl = jnp.clip(mvd_u, D0R * 0.75, 2.5e-3)
    nr = jnp.where(L_qr & (mvd_u != mvd_ucl),
                   _rain_nr_from_mvd(rr, mvd_ucl, c), nr)
    mvd_r = jnp.where(L_qr, mvd_ucl, 0.0)
    L_qs = (qs1d + qsten * DT) > R1
    rs = jnp.where(L_qs, (qs1d + qsten * DT) * rho, R1)
    L_qg = (qg1d + qgten * DT) > R1
    rg = jnp.where(L_qg, (qg1d + qgten * DT) * rho, R1)

    smob, smo2, smo0, smo1, smoc, smod, smoe, smof = \
        _snow_moments(rs, temp, c)
    ilamg, N0_g = _graupel_intercept(rg, temp, mvd_r, L_qr, c)
    ilamr, mvd_r, N0_r = _rain_slope(rr, nr, c)
    if aer:
        ncr = jnp.maximum(2.0, (nc1d + ncten * DT) * rho)
        nwfa = jnp.maximum(11.1e6, (nwfa1d + nwfaten * DT) * rho)

    # ---- cloud water condensation/evaporation (Newton-Raphson) ---------
    cond_on = (ssatw > EPS) | ((ssatw < -EPS) & L_qc)
    clap = (qv - qvs) / (1. + lvt2 * qvs)
    for _ in range(3):
        fcd = qvs * jnp.exp(lvt2 * clap) - qv + clap
        dfcd = qvs * lvt2 * jnp.exp(lvt2 * clap) + 1.
        clap = clap - fcd / dfcd
    xrc = rc + clap
    prw_vcd = jnp.where(cond_on,
                        jnp.where(xrc > 0.0, clap * odt,
                                  -rc / rho * odts), 0.0)
    if aer:
        # droplet NUCLEATION during condensation: activ_ncloud with the
        # reference's activation table, whose file read is fully commented
        # out (table_ccnAct, mp_thompson_aer.f90:956-971, 4542-4598)
        # leaving tnccn_act == 1.0 everywhere, i.e. activated fraction = 1
        # of nwfa (mp_thompson_aer.f90:3026-3034)
        activating = cond_on & (xrc > 0.0) & (clap > EPS)
        xnc_a = jnp.maximum(2.0, nwfa)
        pnc_wcd = jnp.where(activating,
                            jnp.maximum(0.0, xnc_a - ncr) * odts * orho,
                            0.0)
        # droplet EVAPORATION: number of drops smaller than D*-star lost
        # per the tnc_wev lookup (mp_thompson_aer.f90:3037-3092)
        evap_on = cond_on & (xrc > 0.0) & (clap < -EPS) & (ssatw < -1e-6)
        otemp_c = 1.0 / temp
        rvs_c = rho * qvs
        rvs_p_c = rvs_c * otemp_c * (lvap * otemp_c * ORV - 1.)
        rvs_pp_c = rvs_c * (otemp_c * (lvap * otemp_c * ORV - 1.)
                            * otemp_c * (lvap * otemp_c * ORV - 1.)
                            + (-2. * lvap * otemp_c ** 3 * ORV)
                            + otemp_c * otemp_c)
        gamsc_c = lvap * diffu / tcond * rvs_p_c
        alphsc_c = jnp.maximum(1e-9, 0.5 * (gamsc_c / (1. + gamsc_c)) ** 2
                               * rvs_pp_c / rvs_p_c * rvs_c / rvs_p_c)
        xsat_c = jnp.where(jnp.abs(ssatw) < 1e-9, 0.0, ssatw)
        t1_ev = 2. * PI * (1.0 - alphsc_c * xsat_c
                           + 2. * alphsc_c ** 2 * xsat_c ** 2
                           - 5. * alphsc_c ** 3 * xsat_c ** 3) \
            / (1. + gamsc_c)
        Dc_star = jnp.sqrt(jnp.maximum(
            0.0, -2.0 * DT * t1_ev / (2. * PI)
            * 4. * diffu * ssatw * rvs_c / RHO_W))
        idx_d = jnp.clip((1e6 * Dc_star).astype(jnp.int32), 1, NBC) - 1
        idx_n = jnp.clip(_nint(1.0 + NBC * jnp.log(ncr / tt.t_Nc[0])
                               / tt.NIC1), 1, NBC) - 1
        idx_c2 = jnp.where(rc > tt.r_c[0],
                           _mantissa_idx(rc, c.nic2, NTB_C), 0)
        flat_idx = (idx_d * NTB_C + idx_c2) * NBC + idx_n
        tnc = jnp.take(tnc_wev_flat, flat_idx.ravel()).reshape(rc.shape)
        pnc_wcd = jnp.where(
            evap_on,
            jnp.maximum(-ncr * 0.99 * orho * odt, -tnc * orho * odt),
            pnc_wcd)
        # total cloud evaporation removes all droplets
        # (mp_thompson_aer.f90:3086-3089)
        pnc_wcd = jnp.where(cond_on & ~(xrc > 0.0), -ncr * orho * odt,
                            pnc_wcd)
        ncten = ncten + pnc_wcd
        nwfaten = nwfaten - pnc_wcd
    qcten = qcten + prw_vcd
    qvten = qvten - prw_vcd
    tten = tten + lvap * ocp * prw_vcd
    rc = jnp.where(cond_on, jnp.maximum(R1, (qc1d + DT * qcten) * rho), rc)
    if aer:
        ncr = jnp.where(cond_on,
                        jnp.maximum(2.0, (nc1d + DT * ncten) * rho), ncr)
    qv = jnp.where(cond_on, jnp.maximum(1e-10, qv1d + DT * qvten), qv)
    temp = jnp.where(cond_on, t1d + DT * tten, temp)
    rho = 0.622 * pres / (RR2 * temp * (qv + 0.622))
    qvs = rslf(pres, temp)
    ssatw_new = qv / qvs - 1.0
    ssatw = jnp.where(cond_on, ssatw_new, ssatw)

    # ---- rain evaporation (mp_thompson.f90:2410-2475) ------------------
    rev_on = (ssatw < -EPS) & L_qr & ~(prw_vcd > 0.0)
    tempc = temp - 273.15
    otemp = 1.0 / temp
    _, rhof, rhof2, diffu, visco, ocp, vsc2, lvap, tcond = \
        _thermo(temp, pres, qv)
    rvs = rho * qvs
    rvs_p = rvs * otemp * (lvap * otemp * ORV - 1.)
    rvs_pp = rvs * (otemp * (lvap * otemp * ORV - 1.)
                    * otemp * (lvap * otemp * ORV - 1.)
                    + (-2. * lvap * otemp ** 3 * ORV) + otemp * otemp)
    gamsc = lvap * diffu / tcond * rvs_p
    alphsc = jnp.maximum(1e-9, 0.5 * (gamsc / (1. + gamsc)) ** 2
                         * rvs_pp / rvs_p * rvs / rvs_p)
    xsat = jnp.minimum(-1e-9, ssatw)
    t1_evap = 2. * PI * (1.0 - alphsc * xsat + 2. * alphsc ** 2 * xsat ** 2
                         - 5. * alphsc ** 3 * xsat ** 3) / (1. + gamsc)
    lamr_e = 1.0 / ilamr
    tiny_r = (qv / qvs < 0.95) & (rr / rho <= 1e-8)
    rev_big = t1_evap * diffu * (-ssatw) * N0_r * rvs \
        * (c.t1_qr_ev * ilamr ** c.cre[9]
           + c.t2_qr_ev * vsc2 * rhof2
           * ((lamr_e + 0.5 * FV_R) ** (-c.cre[10])))
    rate_max_e = jnp.minimum(rr / rho * odts, (qvs - qv) * odts)
    prv_rev = jnp.where(rev_on,
                        jnp.where(tiny_r, rr / rho * odts,
                                  jnp.minimum(rate_max_e, rev_big / rho)),
                        0.0)
    pnr_rev = jnp.where(rev_on,
                        jnp.minimum(nr * 0.99 / rho * odts,
                                    prv_rev * nr / jnp.maximum(rr, R1)),
                        0.0)
    qrten = qrten - prv_rev
    qvten = qvten + prv_rev
    nrten = nrten - pnr_rev
    tten = tten - lvap * ocp * prv_rev
    if aer:
        # evaporated rain drops release their aerosol back to nwfa
        # (mp_thompson_aer.f90:3178)
        nwfaten = nwfaten + pnr_rev

    rr = jnp.where(rev_on, jnp.maximum(R1, (qr1d + DT * qrten) * rho), rr)
    qv = jnp.where(rev_on, jnp.maximum(1e-10, qv1d + DT * qvten), qv)
    nr = jnp.where(rev_on, jnp.maximum(R2, (nr1d + DT * nrten) * rho), nr)
    temp = jnp.where(rev_on, t1d + DT * tten, temp)
    rho = 0.622 * pres / (RR2 * temp * (qv + 0.622))
    rhof = jnp.sqrt(RHO_NOT / rho)

    # ---- terminal velocities (mp_thompson.f90:2495-2650) ---------------
    has_rr = rr > R1
    lamr_v = (AM_R * c.crg[2] * c.org2 * nr / rr) ** c.obmr
    vtr_m = rhof * AV_R * c.crg[5] * c.org3 * lamr_v ** c.cre[2] \
        * ((lamr_v + FV_R) ** (-c.cre[5]))
    vtr_n = rhof * AV_R * c.crg[6] / c.crg[11] * lamr_v ** c.cre[11] \
        * ((lamr_v + FV_R) ** (-c.cre[6]))
    vtrk = _filldown(jnp.where(has_rr, vtr_m, 0.0), has_rr)
    vtnrk = _filldown(jnp.where(has_rr, vtr_n, 0.0), has_rr)

    has_ri = ri > R1
    lami_v = (AM_I * c.cig[1] * c.oig1 * ni / ri) ** c.obmi
    ilami_v = 1.0 / lami_v
    vti_m = rhof * pp.av_i * c.cig[2] * c.oig2 * ilami_v ** BV_I
    vti_n = rhof * pp.av_i * c.cig[5] / c.cig[6] * ilami_v ** BV_I
    vtik = _filldown(jnp.where(has_ri, vti_m, 0.0), has_ri)
    vtnik = _filldown(jnp.where(has_ri, vti_n, 0.0), has_ri)

    has_rs = rs > R1
    xDs_v = smoc / jnp.maximum(smob, R1)
    Mrat = 1.0 / jnp.maximum(xDs_v, 1e-12)
    ils1 = 1. / (Mrat * LAM0 + pp.fv_s)
    ils2 = 1. / (Mrat * LAM1 + pp.fv_s)
    t1_vts = KAP0 * c.csg[3] * ils1 ** c.cse[3]
    t2_vts = KAP1 * Mrat ** MU_S * c.csg[9] * ils2 ** c.cse[9]
    ils1b = 1. / (Mrat * LAM0)
    ils2b = 1. / (Mrat * LAM1)
    t3_vts = KAP0 * c.csg[0] * ils1b ** c.cse[0]
    t4_vts = KAP1 * Mrat ** MU_S * c.csg[6] * ils2b ** c.cse[6]
    vts = rhof * pp.av_s * (t1_vts + t2_vts) / (t3_vts + t4_vts)
    vts_full = jnp.where(temp > T_0,
                         jnp.maximum(vts * vts_boost, vtrk),
                         vts * vts_boost)
    vtsk = _filldown(jnp.where(has_rs, vts_full, 0.0), has_rs)

    has_rg = rg > R1
    vtg = rhof * pp.av_g * c.cgg[5] * c.ogg3 * ilamg ** pp.bv_g
    vtg_full = jnp.where(temp > T_0, jnp.maximum(vtg, vtrk), vtg)
    vtgk = _filldown(jnp.where(has_rg, vtg_full, 0.0), has_rg)

    O = dict(rr=rr, nr=nr, ri=ri, ni=ni, rs=rs, rg=rg, vtrk=vtrk,
             vtnrk=vtnrk, vtik=vtik, vtnik=vtnik, vtsk=vtsk, vtgk=vtgk,
             rho=rho, ocp=ocp, lvap=lvap, tten=tten, qvten=qvten,
             qcten=qcten, qiten=qiten, niten=niten, qrten=qrten,
             nrten=nrten, qsten=qsten, qgten=qgten)
    if aer:
        O.update(ncten=ncten, nwfaten=nwfaten, nifaten=nifaten, rhof=rhof)
    return O


# the core outputs _post_block reads
_O_NAMES = ("rr", "nr", "ri", "ni", "rs", "rg", "vtrk", "vtnrk", "vtik",
            "vtnik", "vtsk", "vtgk", "rho", "ocp", "lvap", "tten",
            "qvten", "qcten", "qiten", "niten", "qrten", "nrten",
            "qsten", "qgten")


def _post_block(P, O, dzq, DT, c, pp):
    """Sedimentation, (aer) drizzle settling, instant melt /
    homogeneous freeze, and the final update
    (mp_thompson.f90:2657-2844).
    Returns (th, qv, qc, qi, qr, qs, qg, ni, nr[, nc, nwfa, nifa],
    ppt_rain, ppt_ice, ppt_snow, ppt_graupel); the ppt fields keep a
    leading singleton level axis (callers squeeze/slice it)."""
    aer = "ncr" in P
    odt = 1.0 / DT
    qv1d, exner = P["qv1d"], P["exner"]
    if aer:
        nwfa1d, nifa1d = P["nwfa1d"], P["nifa1d"]
    (rr, nr, ri, ni, rs, rg, vtrk, vtnrk, vtik, vtnik, vtsk, vtgk, rho,
     ocp, lvap, tten, qvten, qcten, qiten, niten, qrten, nrten, qsten,
     qgten) = (O[k] for k in _O_NAMES)
    t1d = P["t1d"]
    qc1d, qi1d, ni1d, qr1d, nr1d, qs1d, qg1d = (
        P["qc1d"], P["qi1d"], P["ni1d"], P["qr1d"], P["nr1d"], P["qs1d"],
        P["qg1d"])
    if aer:
        nc1d, w1d, rhof = P["nc1d"], P["w1d"], O["rhof"]
        ncten, nwfaten, nifaten = O["ncten"], O["nwfaten"], O["nifaten"]
        # the drizzle-settling tendency divides by the PRE-update density
        # (the reference's orho is set before the TAU+1 update and never
        # refreshed, mp_thompson_aer.f90:2664) while rc_s uses the final
        # rho — quirk preserved
        orho = 1.0 / P["rho"]
    # post-core temperature: every where-branch of the core's update
    # sections wrote exactly t1d + DT*tten for its cells (the inactive
    # branches add exact zeros to tten), so this recomputation is
    # bit-identical to the value the monolithic formulation carried
    temp = t1d + DT * tten

    # ---- sedimentation -------------------------------------------------
    rr, nr, d_q, d_n, ppt_rain = _sediment(
        rr, nr, vtrk, vtnrk, rho, dzq, DT, True)
    qrten = qrten + d_q
    nrten = nrten + d_n
    ri, ni, d_q, d_n, ppt_ice = _sediment(
        ri, ni, vtik, vtnik, rho, dzq, DT, True, vt_for_cfl=vtik)
    qiten = qiten + d_q
    niten = niten + d_n
    rs, _, d_q, _, ppt_snow = _sediment(
        rs, rs, vtsk, vtsk, rho, dzq, DT, False)
    qsten = qsten + d_q
    rg, _, d_q, _, ppt_graupel = _sediment(
        rg, rg, vtgk, vtgk, rho, dzq, DT, False)
    qgten = qgten + d_q

    if aer:
        # cloud droplet (drizzle) settling within the lowest ~500 m AGL in
        # weak vertical motion (mp_thompson_aer.f90:3252-3272, 3411-3424):
        # a single explicit upstream pass of mass and number
        rc_s = jnp.maximum(R1, (qc1d + qcten * DT) * rho)
        nc_s = jnp.maximum(2.0, (nc1d + ncten * DT) * rho)
        nu_cs = _nu_c_jnp(nc_s)
        g1s, _ = _g_ratios(nu_cs)
        nu_f = nu_cs.astype(jnp.float32)
        lamc_s = (nc_s * AM_R * g1s / rc_s) ** c.obmr
        ilamc_s = 1.0 / lamc_s
        sed_ok = (rc_s > R1) & (w1d < 0.1)
        vtck = jnp.where(sed_ok,
                         rhof * tt.AV_C * (nu_f + 4.) * (nu_f + 5.)
                         * ilamc_s ** tt.BV_C, 0.0)
        vtnck = jnp.where(sed_ok,
                          rhof * tt.AV_C * (nu_f + 1.) * (nu_f + 2.)
                          * ilamc_s ** tt.BV_C, 0.0)
        # only levels whose base is within 500 m of the surface and at or
        # below the highest cloudy level in that layer (ksed1(5))
        agl = jnp.cumsum(dzq, axis=0)
        in_layer = (agl - dzq) < 500.0
        elig = in_layer & (rc_s > R2)
        below_top = jnp.flip(jnp.maximum.accumulate(
            jnp.flip(elig.astype(jnp.int32), axis=0), axis=0),
            axis=0) > 0
        sed_c = vtck * rc_s
        sed_nc = vtnck * nc_s
        zf = jnp.zeros_like(sed_c[:1])
        flux_c = jnp.concatenate([sed_c[1:], zf], axis=0) - sed_c
        flux_n = jnp.concatenate([sed_nc[1:], zf], axis=0) - sed_nc
        qcten = qcten + jnp.where(below_top, flux_c / dzq * orho, 0.0)
        ncten = ncten + jnp.where(below_top, flux_n / dzq * orho, 0.0)

    # ---- instant melt / homogeneous freeze (mp_thompson.f90:2786-2810) -
    xri = jnp.maximum(0.0, qi1d + qiten * DT)
    melt = (temp > T_0) & (xri > 0.0)
    qcten = qcten + jnp.where(melt, xri * odt, 0.0)
    qiten = qiten - jnp.where(melt, xri * odt, 0.0)
    niten = jnp.where(melt, -ni1d * odt, niten)
    tten = tten - jnp.where(melt, LFUS * ocp * xri * odt, 0.0)

    xrc = jnp.maximum(0.0, qc1d + qcten * DT)
    frz = (temp < HGFR) & (xrc > 0.0)
    lfus2 = LSUB - lvap
    qiten = qiten + jnp.where(frz, xrc * odt, 0.0)
    niten = niten + jnp.where(frz, xrc / XM0I * odt, 0.0)
    qcten = qcten - jnp.where(frz, xrc * odt, 0.0)
    tten = tten + jnp.where(frz, lfus2 * ocp * xrc * odt, 0.0)

    # ---- final update (mp_thompson.f90:2815-2844) ----------------------
    t_out = t1d + tten * DT
    qv_out = jnp.maximum(1e-10, qv1d + qvten * DT)
    qc_out = qc1d + qcten * DT
    qc_out = jnp.where(qc_out <= R1, 0.0, qc_out)
    qi_out = qi1d + qiten * DT
    ni_out = jnp.maximum(R2 / rho, ni1d + niten * DT)
    gone_i = qi_out <= R1
    lami_f = (AM_I * c.cig[1] * c.oig1 * ni_out
              / jnp.maximum(qi_out, R1)) ** c.obmi
    xDi_f = (BM_I + c.mu_i + 1.0) / lami_f
    lami_f = jnp.where(xDi_f < 20e-6, c.cie[1] / 20e-6,
                       jnp.where(xDi_f > 300e-6, c.cie[1] / 300e-6, lami_f))
    ni_out = jnp.where(gone_i, 0.0,
                       jnp.minimum(c.cig[0] * c.oig2 * qi_out / AM_I
                                   * lami_f ** BM_I, 250e3 / rho))
    qi_out = jnp.where(gone_i, 0.0, qi_out)
    qr_out = qr1d + qrten * DT
    nr_out = jnp.maximum(R2 / rho, nr1d + nrten * DT)
    gone_r = qr_out <= R1
    lamr_f = (AM_R * c.crg[2] * c.org2 * nr_out
              / jnp.maximum(qr_out, R1)) ** c.obmr
    mvd_f = jnp.clip((3.0 + c.mu_r + 0.672) / lamr_f, D0R * 0.75, 2.5e-3)
    nr_out = jnp.where(gone_r, 0.0, _rain_nr_from_mvd(qr_out, mvd_f, c))
    qr_out = jnp.where(gone_r, 0.0, qr_out)
    qs_out = qs1d + qsten * DT
    qs_out = jnp.where(qs_out <= R1, 0.0, qs_out)
    qg_out = qg1d + qgten * DT
    qg_out = jnp.where(qg_out <= R1, 0.0, qg_out)

    # driver-level qv floor (mp_gt_driver, :1005-1020). The reference's
    # neighbor-average smoothing there is dead code: its own inner
    # `if (qv1d(k) < 1e-7)` re-tests the ORIGINAL value and always
    # overwrites the average with 1e-7, so the net effect is a floor.
    qv_out = jnp.maximum(qv_out, 1e-7)

    th_out = t_out / exner
    if not aer:
        return (th_out, qv_out, qc_out, qi_out, qr_out, qs_out, qg_out,
                ni_out, nr_out, ppt_rain, ppt_ice, ppt_snow, ppt_graupel)

    # final droplet-number and aerosol updates with size-consistency and
    # concentration caps (mp_thompson_aer.f90:3540-3561)
    nc_out = jnp.maximum(2.0 / rho, nc1d + ncten * DT)
    nwfa_out = jnp.clip(nwfa1d + nwfaten * DT, 11.1e6 / rho,
                        9999.0e6 / rho)
    nifa_out = jnp.clip(nifa1d + nifaten * DT, tt.NA_IN1 * 0.01,
                        9999.0e6 / rho)
    gone_c = qc_out <= R1
    nu_cf = _nu_c_jnp(jnp.maximum(2.0, nc_out * rho))
    g1f, _ = _g_ratios(nu_cf)
    lamc_f = (AM_R * g1f * nc_out / jnp.maximum(qc_out, R1)) ** c.obmr
    xDc_f = (BM_R + nu_cf + 1.0) / lamc_f
    cce2f = BM_R + nu_cf.astype(jnp.float32) + 1.0
    lamc_f = jnp.where(xDc_f < D0C, cce2f / D0C,
                       jnp.where(xDc_f > D0R * 2., cce2f / (D0R * 2.),
                                 lamc_f))
    nc_out = jnp.where(gone_c, 0.0,
                       jnp.minimum(qc_out / (AM_R * g1f)
                                   * lamc_f ** BM_R,
                                   tt.NT_C_MAX / rho))
    return (th_out, qv_out, qc_out, qi_out, qr_out, qs_out, qg_out,
            ni_out, nr_out, nc_out, nwfa_out, nifa_out,
            ppt_rain, ppt_ice, ppt_snow, ppt_graupel)


@functools.partial(jax.jit, static_argnames=("params_key",))
def _mp_thompson_impl(th, qv1d, qc1d, qi1d, qr1d, qs1d, qg1d, ni1d, nr1d,
                      exner, p1d, dzq, dt, tables, params_key,
                      nc1d=None, nwfa1d=None, nifa1d=None, w1d=None,
                      tnc_wev_flat=None):
    """One Thompson step: prep -> indices -> table lookups -> core ->
    sedimentation -> final update (mp_thompson.f90:1057-2844)."""
    params = ThompsonParams(**dict(params_key))
    _, c = get_tables(params)
    pp = params
    DT = dt
    odt = 1.0 / dt
    dtype = th.dtype
    # Thompson-Eidhammer aerosol-aware mode (is_aerosol_aware,
    # mp_thompson_aer.f90:58,440): active when prognostic nc/nwfa/nifa
    # are supplied; otherwise the constant-Nt_c fallback
    aer = nc1d is not None

    P = _prep_block(th, qv1d, qc1d, qi1d, qr1d, qs1d, qg1d, ni1d, nr1d,
                    exner, p1d, c, pp, nc1d=nc1d, nwfa1d=nwfa1d,
                    nifa1d=nifa1d, w1d=w1d)
    I = _index_block(P, c)
    G = _gather_all(tables, I, dtype, P=P)
    O = _core_block(P, I["idx_i"], G, DT, c, pp,
                    tnc_wev_flat=tnc_wev_flat)
    outs = _post_block(P, O, dzq, DT, c, pp)
    if not aer:
        (th_out, qv_out, qc_out, qi_out, qr_out, qs_out, qg_out, ni_out,
         nr_out, ppt_rain, ppt_ice, ppt_snow, ppt_graupel) = outs
        return (th_out, qv_out, qc_out, qi_out, qr_out, qs_out, qg_out,
                ni_out, nr_out, ppt_rain[0], ppt_ice[0], ppt_snow[0],
                ppt_graupel[0])
    (th_out, qv_out, qc_out, qi_out, qr_out, qs_out, qg_out, ni_out,
     nr_out, nc_out, nwfa_out, nifa_out, ppt_rain, ppt_ice, ppt_snow,
     ppt_graupel) = outs
    return (th_out, qv_out, qc_out, qi_out, qr_out, qs_out, qg_out,
            ni_out, nr_out, nc_out, nwfa_out, nifa_out,
            ppt_rain[0], ppt_ice[0], ppt_snow[0], ppt_graupel[0])


def mp_thompson(th, qv, qc, qi, qr, qs_, qg, ni, nr, exner, p, dz, dt,
                rain, snow, graupel, params: ThompsonParams = None):
    """One Thompson step over the full grid (mp_gt_driver,
    mp_thompson.f90:772-1044). rain/snow/graupel are (y, x) accumulators
    [mm]; ni/nr are number mixing ratios [kg^-1].

    Returns (th, qv, qc, qi, qr, qs, qg, ni, nr, rain, snow, graupel)."""
    params = params or ThompsonParams()
    tables = _prep_tables(params)
    key = tuple(sorted(vars(params).items()))
    (th, qv, qc, qi, qr, qs_, qg, ni, nr,
     ppt_rain, ppt_ice, ppt_snow, ppt_graupel) = _mp_thompson_impl(
        th, qv, qc, qi, qr, qs_, qg, ni, nr, exner, p, dz,
        jnp.asarray(dt, th.dtype), tables, key)
    rain = rain + ppt_rain + ppt_snow + ppt_graupel + ppt_ice
    snow = snow + ppt_snow + ppt_ice
    graupel = graupel + ppt_graupel
    return th, qv, qc, qi, qr, qs_, qg, ni, nr, rain, snow, graupel


# registry name -> scheme-order position of (th, qv, qc, qi, qr, qs,
# qg, ni, nr)
_STACK_FIELDS = {
    "potential_temperature": 0, "water_vapor": 1, "cloud_water": 2,
    "cloud_ice": 3, "rain_mass": 4, "snow_mass": 5, "graupel_mass": 6,
    "ice_number": 7, "rain_number": 8,
}


def stack_smap(names):
    """smap for mp_thompson_stack: scheme position -> stack row, or None
    if ``names`` is not exactly the 9 Thompson-advected species."""
    if len(names) != 9 or set(names) != set(_STACK_FIELDS):
        return None
    smap = [0] * 9
    for row, n in enumerate(names):
        smap[_STACK_FIELDS[n]] = row
    return tuple(smap)


@functools.partial(jax.jit, static_argnames=("params_key", "smap"))
def _mp_thompson_stack_impl(qstack, exner, p1d, dzq, dt, tables,
                            params_key, smap):
    """Stack-native Thompson step: the advected-species stack goes in and
    comes out in STACK order, so the interval loop's carry feeds the
    scheme (and the scheme feeds advection) with zero restacking. The
    prep/index/gather stages read the fields as zero-copy slices."""
    params = ThompsonParams(**dict(params_key))
    _, c = get_tables(params)
    th, qv1d, qc1d, qi1d, qr1d, qs1d, qg1d, ni1d, nr1d = (
        qstack[i] for i in smap)
    dtype = qstack.dtype
    P = _prep_block(th, qv1d, qc1d, qi1d, qr1d, qs1d, qg1d, ni1d, nr1d,
                    exner, p1d, c, params)
    I = _index_block(P, c)
    G = _gather_all(tables, I, dtype, P=P)
    O = _core_block(P, I["idx_i"], G, dt, c, params)
    outs = _post_block(P, O, dzq, dt, c, params)
    inv = [0] * 9
    for pos, row in enumerate(smap):
        inv[row] = pos
    out_stack = jnp.stack([outs[inv[r]] for r in range(9)])
    return (out_stack, outs[9][0], outs[10][0], outs[11][0], outs[12][0])


def mp_thompson_stack(qstack, names, exner, p, dz, dt, rain, snow,
                      graupel, params: ThompsonParams = None):
    """One Thompson step on the advected-species stack (stack order given
    by ``names``; must be exactly the 9 Thompson species — use
    ``stack_smap`` to validate). Returns (out_stack, rain, snow,
    graupel)."""
    smap = stack_smap(tuple(names))
    assert smap is not None
    params = params or ThompsonParams()
    tables = _prep_tables(params)
    key = tuple(sorted(vars(params).items()))
    out_stack, ppt_rain, ppt_ice, ppt_snow, ppt_graupel = \
        _mp_thompson_stack_impl(
            qstack, exner, p, dz, jnp.asarray(dt, qstack.dtype), tables,
            key, smap)
    rain = rain + ppt_rain + ppt_snow + ppt_graupel + ppt_ice
    snow = snow + ppt_snow + ppt_ice
    graupel = graupel + ppt_graupel
    return out_stack, rain, snow, graupel


def mp_thompson_aer(th, qv, qc, qi, qr, qs_, qg, ni, nr, nc, nwfa, nifa,
                    exner, p, dz, dt, rain, snow, graupel, w=None,
                    params: ThompsonParams = None):
    """One aerosol-aware Thompson-Eidhammer step (is_aerosol_aware=.true.
    path of mp_thompson_aer.f90): prognostic cloud-droplet number nc and
    water/ice-friendly aerosol numbers nwfa/nifa (all [kg^-1]) drive
    droplet activation, DeMott (2010) dust ice nucleation, Koop (2001)
    homogeneous freezing, and are wet-scavenged by precipitation.

    Returns (th, qv, qc, qi, qr, qs, qg, ni, nr, nc, nwfa, nifa,
    rain, snow, graupel)."""
    params = params or ThompsonParams()
    tables = _prep_tables(params)
    key = tuple(sorted(vars(params).items()))
    tnc_flat = jnp.asarray(tt.get_aer_tables()["tnc_wev"].ravel(), th.dtype)
    (th, qv, qc, qi, qr, qs_, qg, ni, nr, nc, nwfa, nifa,
     ppt_rain, ppt_ice, ppt_snow, ppt_graupel) = _mp_thompson_impl(
        th, qv, qc, qi, qr, qs_, qg, ni, nr, exner, p, dz,
        jnp.asarray(dt, th.dtype), tables, key,
        nc1d=nc, nwfa1d=nwfa, nifa1d=nifa, w1d=w, tnc_wev_flat=tnc_flat)
    rain = rain + ppt_rain + ppt_snow + ppt_graupel + ppt_ice
    snow = snow + ppt_snow + ppt_ice
    graupel = graupel + ppt_graupel
    return (th, qv, qc, qi, qr, qs_, qg, ni, nr, nc, nwfa, nifa,
            rain, snow, graupel)


def aer_surface_flux(nwfa_sfc, dx, dy=None):
    """CCN surface-emission rate nwfa2d [kg^-1 s^-1] derived from the
    INITIAL lowest-level nwfa (thompson_aer_init,
    mp_thompson_aer.f90:536-549): a first-order replenishment that emits
    more where aerosols are already plentiful (0.875e4 /kg/s at
    50 /cc, x10 per decade), scaled down for grids finer than 20 km.
    Applied to the lowest level every microphysics call
    (mp_gt_driver, mp_thompson_aer.f90:1233) so long runs do not
    scavenge nwfa to the floor."""
    dy = dx if dy is None else dy
    s = float(np.sqrt(dx * dy))
    if s / 20000.0 >= 1.0:
        h_01 = 0.875
    else:
        h_01 = (0.875 + 0.125 * ((20000.0 - s) / 16000.0)) * s / 20000.0
    return 10.0 ** (np.log10(nwfa_sfc * 1e-6) - 3.69897) * h_01 * 1e6


def aer_init_profiles(z_agl, terrain):
    """Default CCN/IN aerosol profiles for runs without aerosol input
    data: exponential decay with a terrain-elevation-dependent scale
    (thompson_aer_init, mp_thompson_aer.f90:454-516). ``z_agl`` is height
    above ground (z, y, x) [m], ``terrain`` surface elevation (y, x) [m].
    The reference assigns these concentrations directly to its [kg^-1]
    aerosol arrays (no density division) — reproduced as-is."""
    h_01 = np.where(terrain <= 1000.0, 0.8,
                    np.where(terrain >= 2500.0, 0.01,
                             0.8 * np.cos(terrain * 0.001 - 1.0)))[None]
    niCCN3 = -1.0 * np.log(tt.NA_CCN1 / tt.NA_CCN0) / h_01
    niIN3 = -1.0 * np.log(tt.NA_IN1 / tt.NA_IN0) / h_01
    nwfa = tt.NA_CCN1 + tt.NA_CCN0 * np.exp(-(z_agl / 1000.0) * niCCN3)
    nifa = tt.NA_IN1 + tt.NA_IN0 * np.exp(-(z_agl / 1000.0) * niIN3)
    return nwfa, nifa


# 1-indexed gamma ratios G(i+4)/G(i+1) = (i+1)(i+2)(i+3) for the cloud
# droplet shape-parameter family (calc_effectRad g_ratio,
# mp_thompson_aer.f90:5045-5046)
_G_RATIO = jnp.asarray([24., 60., 120., 210., 336., 504., 720., 990.,
                        1320., 1716., 2184., 2730., 3360., 4080., 4896.])


def calc_effect_rad(t, p, qv, qc, qi, ni, qs_, params: ThompsonParams
                    = None, nc=None):
    """Cloud/ice/snow effective radii [m] for radiation coupling
    (calc_effectRad, mp_thompson_aer.f90:5026-5127).

    ``nc`` is the prognostic droplet number [kg^-1] in aerosol-aware runs;
    without it the droplet number is the constant Nt_c — the fallback the
    reference driver always hits (mp_driver.f90:446-476 passes no
    nc/nwfa/nifa)."""
    params = params or ThompsonParams()
    _, c = get_tables(params)
    rho = 0.622 * p / (RR2 * t * (qv + 0.622))
    rc = jnp.maximum(R1, qc * rho)
    if nc is None:
        nc = jnp.full_like(rc, params.Nt_c)      # non-aerosol fallback
    else:
        nc = jnp.maximum(2.0, nc * rho)
    ri = jnp.maximum(R1, qi * rho)
    ni_ = jnp.maximum(R2, ni * rho)
    rs = jnp.maximum(R1, qs_ * rho)

    # cloud droplets: generalized-gamma with Nc-dependent shape
    inu_c = jnp.clip(jnp.rint(1000e6 / nc).astype(jnp.int32) + 2, 2, 15)
    inu_c = jnp.where(nc < 100.0, 15, inu_c)
    g_r = _G_RATIO[inu_c - 1]
    lamc = (nc * AM_R * g_r / rc) ** c.obmr
    re_qc = jnp.clip(0.5 * (3.0 + inu_c) / lamc, 2.51e-6, 50e-6)
    re_qc = jnp.where((rc > R1) & (nc > R2), re_qc, 2.49e-6)

    # cloud ice
    lami = (AM_I * c.cig[1] * c.oig1 * ni_ / ri) ** c.obmi
    re_qi = jnp.clip(0.5 * (3.0 + c.mu_i) / lami, 5.01e-6, 125e-6)
    re_qi = jnp.where((ri > R1) & (ni_ > R2), re_qi, 4.99e-6)

    # snow: ratio of the (bm_s+1)-th to bm_s-th Field moments
    smob, _, _, _, smoc, _, _, _ = _snow_moments(rs, t, c)
    re_qs = jnp.clip(0.5 * smoc / smob, 10e-6, 999e-6)
    re_qs = jnp.where(rs > R1, re_qs, 9.99e-6)
    return re_qc, re_qi, re_qs
