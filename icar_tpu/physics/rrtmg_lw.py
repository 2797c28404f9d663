"""RRTMG longwave radiation (rad=3), a JAX rewrite.

Re-implementation of rrtmg_lw (/root/reference/src/physics/ra_rrtmg_lw.f90,
AER Inc.'s RRTMG-LW v4.84 as carried by WRF/ICAR): correlated-k gas optics
over 16 bands / 140 g-points, McICA cloud sampling with configurable
overlap, and the RRTM radiative transfer with the secant-diffusivity-angle
approximation.

Differences from the reference, all deliberate:
  * per-column vectorization — the reference's column loop and
    per-column ``laytrop`` split become where-masks over (nlay, ncol);
  * the exp/tau/Pade lookup tables (rrlw_tbl) are replaced by direct
    evaluation of exp(-tau) and the linear-in-tau transition function —
    the tables are a scalar-CPU optimization a vector machine doesn't
    need;
  * McICA subcolumns use jax PRNG instead of the reference's KISS
    generator (mcica_subcol_gen_lw.f90) — statistically equivalent
    random/maximum-random overlap;
  * the k-distribution data come from the same external
    ``rrtmg_support/*.nc`` files the reference reads (not shipped with
    either repository); machinery tests run on synthetic tables.

The in-source physical tables (Planck integrals, MLS reference profiles,
cloud optics fits) live in data/rrtmg_lw_data.npz (see
tools/extract_rrtmg_data.py).
"""

from __future__ import annotations

import os
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np

from .rrtmg_lw_tables import (NBANDS, NGPTLW, NGC, NGS, NGB, NSPA, NSPB,
                              DELWAVE, NO_KB, FRACA_ETA, FRACB_ETA)

_DATA = np.load(os.path.join(os.path.dirname(__file__), "data",
                             "rrtmg_lw_data.npz"))
TOTPLNK = jnp.asarray(_DATA["totplnk"])     # (181, 16)
TOTPLK16 = jnp.asarray(_DATA["totplk16"])   # (181,)
PREFLOG = jnp.asarray(_DATA["preflog"])     # (59,)
TREF = jnp.asarray(_DATA["tref"])           # (59,)
CHI_MLS = jnp.asarray(_DATA["chi_mls"])     # (7, 59)
ABSLIQ1 = jnp.asarray(_DATA["absliq1"])     # (58, 16)
ABSICE0 = np.asarray(_DATA["absice0"])      # (2,)
ABSICE1 = np.asarray(_DATA["absice1"])      # (2, 5)
ABSICE2 = jnp.asarray(_DATA["absice2"])     # (43, 16)
ABSICE3 = jnp.asarray(_DATA["absice3"])     # (46, 16)

GRAV = 9.8066
AVOGAD = 6.02214199e23
AMD = 28.9660          # molecular weight dry air
AMW = 18.0160          # molecular weight water
FLUXFAC = np.pi * 2.e4
HEATFAC = 8.4391       # K/day per (W/m2 / (hPa)) (rrlw_con)
ONEMINUS = 1.0 - 1e-6
SECDIFF_A0 = np.array([1.66, 1.55, 1.58, 1.66, 1.54, 1.454, 1.89, 1.33,
                       1.668, 1.66, 1.66, 1.66, 1.66, 1.66, 1.66, 1.66])
SECDIFF_A1 = np.array([0.0, 0.25, 0.22, 0.0, 0.13, 0.446, -0.10, 0.40,
                       -0.006, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
SECDIFF_A2 = np.array([0.0, -12.0, -11.7, 0.0, -0.72, -0.243, 0.19,
                       -0.062, 0.414, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
WTDIFF = 0.5
REC_6 = 0.166667

# default trace-gas volume mixing ratios (inatm/WRF rrtmg_lwrad defaults;
# CLWRF GHG input overrides these when read_ghg is enabled)
CO2VMR = 379e-6
N2OVMR = 319e-9
CH4VMR = 1774e-9
O2VMR = 0.209488
# CFC defaults (ra_rrtmg_lw.f90:11770-11780)
CFC11VMR = 0.251e-9
CFC12VMR = 0.538e-9
CFC22VMR = 0.169e-9
CCL4VMR = 0.093e-9


def _tfn(od):
    """Linear-in-tau Planck transition function (the tfn_tbl contents,
    rrtmg_lw_ini :7958-7976): tau/6 for small tau else
    1 - 2*(1/tau - exp(-tau)/(1-exp(-tau)))."""
    tr = jnp.exp(-od)
    big = 1.0 - 2.0 * (1.0 / jnp.maximum(od, 1e-12)
                       - tr / jnp.maximum(1.0 - tr, 1e-12))
    return jnp.where(od < 0.06, od / 6.0, big)


# ==========================================================================
# setcoef (ra_rrtmg_lw.f90:3430-3930)
# ==========================================================================

def setcoef(pavel, tavel, tz, tbound, semiss, coldry, wkl, wbroad):
    """Interpolation indices/fractions + Planck functions.

    pavel/tavel: (nlay, N); tz: (nlay+1, N) level temps (tz[0] = surface
    level); tbound: (N,) surface skin temperature; wkl: (7, nlay, N)
    molecular amounts; returns a namespace of (nlay, N) arrays plus
    planck tables."""
    stpfac = 296.0 / 1013.0

    def planck_index(t):
        ind = jnp.clip(jnp.floor(t - 159.0).astype(jnp.int32), 1, 180)
        frac = t - 159.0 - ind.astype(jnp.float32)
        return ind - 1, frac        # 0-based

    indbound, tbndfrac = planck_index(tbound)
    indlay, tlayfrac = planck_index(tavel)
    indlev, tlevfrac = planck_index(tz)

    # totplnk is (181, 16); band 16 uses totplk16 (:3646-3652)
    tot = jnp.concatenate([TOTPLNK[:, :15], TOTPLK16[:, None]], axis=1)

    def planck_interp(ind, frac):
        # ind (..., ), returns (..., 16)
        v0 = tot[ind]
        v1 = tot[ind + 1]
        return v0 + frac[..., None] * (v1 - v0)

    plankbnd = semiss * planck_interp(indbound, tbndfrac)
    planklay = planck_interp(indlay, tlayfrac)       # (nlay, N, 16)
    planklev = planck_interp(indlev, tlevfrac)       # (nlay+1, N, 16)

    plog = jnp.log(pavel)
    jp = jnp.clip(jnp.floor(36.0 - 5.0 * (plog + 0.04)).astype(jnp.int32),
                  1, 58)
    jp0 = jp - 1
    fp = 5.0 * (PREFLOG[jp0] - plog)
    jt = jnp.clip(jnp.floor(3.0 + (tavel - TREF[jp0]) / 15.0).astype(
        jnp.int32), 1, 4)
    ft = (tavel - TREF[jp0]) / 15.0 - (jt - 3).astype(jnp.float32)
    jt1 = jnp.clip(jnp.floor(3.0 + (tavel - TREF[jp0 + 1]) / 15.0).astype(
        jnp.int32), 1, 4)
    ft1 = (tavel - TREF[jp0 + 1]) / 15.0 - (jt1 - 3).astype(jnp.float32)

    water = wkl[0] / coldry
    scalefac = pavel * stpfac / tavel
    tropo = plog > 4.56          # lower atmosphere mask

    forfac = scalefac / (1.0 + water)
    factor_t = (332.0 - tavel) / 36.0
    indfor = jnp.where(
        tropo,
        jnp.clip(jnp.floor(factor_t).astype(jnp.int32), 1, 2), 3)
    forfrac = jnp.where(
        tropo, factor_t - indfor.astype(jnp.float32),
        (tavel - 188.0) / 36.0 - 1.0)
    selffac = water * forfac
    factor_s = (tavel - 188.0) / 7.2
    indself = jnp.clip(jnp.floor(factor_s).astype(jnp.int32) - 7, 1, 9)
    selffrac = factor_s - (indself + 7).astype(jnp.float32)
    scaleminor = pavel / tavel
    scaleminorn2 = scaleminor * (wbroad / (coldry + wkl[0]))
    factor_m = (tavel - 180.8) / 7.2
    indminor = jnp.clip(jnp.floor(factor_m).astype(jnp.int32), 1, 18)
    minorfrac = factor_m - indminor.astype(jnp.float32)

    def chi_rat(i, j, off=0):
        return CHI_MLS[i, jp0 + off] / CHI_MLS[j, jp0 + off]

    rat = SimpleNamespace(
        h2oco2=chi_rat(0, 1), h2oco2_1=chi_rat(0, 1, 1),
        h2oo3=chi_rat(0, 2), h2oo3_1=chi_rat(0, 2, 1),
        h2on2o=chi_rat(0, 3), h2on2o_1=chi_rat(0, 3, 1),
        h2och4=chi_rat(0, 5), h2och4_1=chi_rat(0, 5, 1),
        n2oco2=chi_rat(3, 1), n2oco2_1=chi_rat(3, 1, 1),
        o3co2=chi_rat(2, 1), o3co2_1=chi_rat(2, 1, 1))

    def col(i):
        c = 1e-20 * wkl[i]
        return jnp.where(c == 0.0, 1e-32 * coldry, c) if i != 0 else c

    colh2o = 1e-20 * wkl[0]
    colco2 = col(1)
    colo3 = col(2)
    coln2o = col(3)
    colco = col(4)
    colch4 = col(5)
    colo2 = 1e-20 * wkl[6]
    colbrd = 1e-20 * wbroad

    compfp = 1.0 - fp
    fac10 = compfp * ft
    fac00 = compfp * (1.0 - ft)
    fac11 = fp * ft1
    fac01 = fp * (1.0 - ft1)
    selffac = colh2o * selffac
    forfac = colh2o * forfac

    return SimpleNamespace(
        tropo=tropo, jp=jp, jt=jt, jt1=jt1, fac00=fac00, fac01=fac01,
        fac10=fac10, fac11=fac11, forfac=forfac, forfrac=forfrac,
        indfor=indfor, selffac=selffac, selffrac=selffrac,
        indself=indself, indminor=indminor, minorfrac=minorfrac,
        scaleminor=scaleminor, scaleminorn2=scaleminorn2, rat=rat,
        colh2o=colh2o, colco2=colco2, colo3=colo3, coln2o=coln2o,
        colco=colco, colch4=colch4, colo2=colo2, colbrd=colbrd,
        plankbnd=plankbnd, planklay=planklay, planklev=planklev,
        pavel=pavel, coldry=coldry)


# ==========================================================================
# taumol helpers
# ==========================================================================

def _selffor(t, c):
    """Self + foreign continuum (shared by every band)."""
    selfref, forref = t["selfref"], t["forref"]
    inds0 = c.indself - 1
    indf0 = c.indfor - 1
    tauself = c.selffac[..., None] * (
        selfref[inds0] + c.selffrac[..., None]
        * (selfref[inds0 + 1] - selfref[inds0]))
    taufor = c.forfac[..., None] * (
        forref[indf0] + c.forfrac[..., None]
        * (forref[indf0 + 1] - forref[indf0]))
    return tauself, taufor


def _ind_a(c, band, js=None):
    """1-based flat lower-table index ind0/ind1 -> 0-based."""
    nsp = int(NSPA[band - 1])
    base0 = ((c.jp - 1) * 5 + (c.jt - 1)) * nsp
    base1 = (c.jp * 5 + (c.jt1 - 1)) * nsp
    if js is None:
        return base0, base1
    return base0 + js - 1, None  # callers add js1 themselves


def _ind_b(c, band):
    nsp = max(int(NSPB[band - 1]), 1)
    base0 = ((c.jp - 13) * 5 + (c.jt - 1)) * nsp
    base1 = ((c.jp - 12) * 5 + (c.jt1 - 1)) * nsp
    return base0, base1


def _major_1sp(table, ind0, ind1, c):
    """4-point (p, T) interpolation for single-species bands."""
    return (c.fac00[..., None] * table[ind0]
            + c.fac10[..., None] * table[ind0 + 1]
            + c.fac01[..., None] * table[ind1]
            + c.fac11[..., None] * table[ind1 + 1])


def _spec(col1, rat, col2, mult):
    """Binary-species parameters (speccomb, js (1-based), fs, specparm)."""
    speccomb = col1 + rat * col2
    specparm = jnp.minimum(col1 / speccomb, ONEMINUS)
    specmult = mult * specparm
    js = 1 + jnp.floor(specmult).astype(jnp.int32)
    fs = jnp.mod(specmult, 1.0)
    return speccomb, specparm, js, fs


def _major_9sp(table, base, js, fs, specparm, facA, facB, stride=9):
    """Lower-atmosphere 9-species eta interpolation with the
    specparm < 0.125 / > 0.875 end treatments (e.g. taugb3,
    ra_rrtmg_lw.f90:5159-5320). base is the 0-based (jp, jt) offset;
    facA/facB are (fac00, fac10) or (fac01, fac11)."""
    ind = base + js - 1          # 0-based center index
    lo = specparm < 0.125
    hi = specparm > 0.875
    p = jnp.where(lo, fs - 1.0, -fs)
    p4 = p ** 4
    fk0 = p4
    fk1 = 1.0 - p - 2.0 * p4
    fk2 = p + p4
    fA, fB = facA[..., None], facB[..., None]
    fk0e, fk1e, fk2e = fk0[..., None], fk1[..., None], fk2[..., None]
    fse = fs[..., None]

    t = lambda off: table[ind + off]
    mid = (fA * ((1.0 - fse) * t(0) + fse * t(1))
           + fB * ((1.0 - fse) * t(stride) + fse * t(stride + 1)))
    lo_v = (fA * (fk0e * t(0) + fk1e * t(1) + fk2e * t(2))
            + fB * (fk0e * t(stride) + fk1e * t(stride + 1)
                    + fk2e * t(stride + 2)))
    hi_v = (fA * (fk2e * t(-1) + fk1e * t(0) + fk0e * t(1))
            + fB * (fk2e * t(stride - 1) + fk1e * t(stride)
                    + fk0e * t(stride + 1)))
    loe = lo[..., None]
    hie = hi[..., None]
    return jnp.where(loe, lo_v, jnp.where(hie, hi_v, mid))


def _minor_eta(kminor, jm, fm, indm, minorfrac):
    """Minor gas with eta + temperature interpolation (e.g. n2o in
    band 3). kminor (neta, 19, g)."""
    jm0 = jm - 1
    im0 = indm - 1
    mfe = minorfrac[..., None]
    fme = fm[..., None]
    m1 = kminor[jm0, im0] + fme * (kminor[jm0 + 1, im0]
                                   - kminor[jm0, im0])
    m2 = kminor[jm0, im0 + 1] + fme * (kminor[jm0 + 1, im0 + 1]
                                       - kminor[jm0, im0 + 1])
    return m1 + mfe * (m2 - m1)


def _minor_t(kminor, indm, minorfrac):
    """Minor gas with temperature-only interpolation. kminor (19, g)."""
    im0 = indm - 1
    return kminor[im0] + minorfrac[..., None] * (kminor[im0 + 1]
                                                 - kminor[im0])


def _planck_eta(fracref, jpl, fpl):
    """Eta-interpolated Planck fraction; fracref (g, 9) or (g, 5)."""
    f = fracref.T     # (eta, g)
    j0 = jpl - 1
    return f[j0] + fpl[..., None] * (f[j0 + 1] - f[j0])


def _adjcol(colgas, coldry, jp, chi_index, thresh, base, expo,
            chi_ref=None):
    """Empirical high-concentration adjustment for minor-gas columns
    (e.g. n2o in band 3, :5124-5131)."""
    chi = CHI_MLS[chi_index, jp - 1 + 1] if chi_ref is None else chi_ref
    ratio = 1e20 * (colgas / coldry) / chi
    adjfac = base + (ratio - base) ** expo
    adj = adjfac * chi * coldry * 1e-20
    return jnp.where(ratio > thresh, adj, colgas)


def _g(table, idx):
    """Clipped gather on axis 0 (out-of-range rows are masked out by the
    tropo/strato where-select)."""
    return table[jnp.clip(idx, 0, table.shape[0] - 1)]


def _major_1sp_c(table, ind0, ind1, c):
    return (c.fac00[..., None] * _g(table, ind0)
            + c.fac10[..., None] * _g(table, ind0 + 1)
            + c.fac01[..., None] * _g(table, ind1)
            + c.fac11[..., None] * _g(table, ind1 + 1))


def _major_9sp_clipped(table, ind, fs, specparm, facA, facB, stride):
    lo = specparm < 0.125
    hi = specparm > 0.875
    p = jnp.where(lo, fs - 1.0, -fs)
    p4 = p ** 4
    fk0, fk1, fk2 = p4, 1.0 - p - 2.0 * p4, p + p4
    fA, fB = facA[..., None], facB[..., None]
    fk0e, fk1e, fk2e = fk0[..., None], fk1[..., None], fk2[..., None]
    fse = fs[..., None]
    t = lambda off: table[jnp.clip(ind + off, 0, table.shape[0] - 1)]
    mid = (fA * ((1.0 - fse) * t(0) + fse * t(1))
           + fB * ((1.0 - fse) * t(stride) + fse * t(stride + 1)))
    lo_v = (fA * (fk0e * t(0) + fk1e * t(1) + fk2e * t(2))
            + fB * (fk0e * t(stride) + fk1e * t(stride + 1)
                    + fk2e * t(stride + 2)))
    hi_v = (fA * (fk2e * t(-1) + fk1e * t(0) + fk0e * t(1))
            + fB * (fk2e * t(stride - 1) + fk1e * t(stride)
                    + fk0e * t(stride + 1)))
    return jnp.where(lo[..., None], lo_v,
                     jnp.where(hi[..., None], hi_v, mid))


def _band_2sp_lower(t, c, band, col1, col2, rat0, rat1, mult=8.0):
    """Shared lower-atmosphere two-species major absorption."""
    nsp = int(NSPA[band - 1])
    sc0, sp0, js0, fs0 = _spec(col1, rat0, col2, mult)
    sc1, sp1, js1, fs1 = _spec(col1, rat1, col2, mult)
    base0 = ((c.jp - 1) * 5 + (c.jt - 1)) * nsp
    base1 = (c.jp * 5 + (c.jt1 - 1)) * nsp
    tmaj0 = sc0[..., None] * _major_9sp_clipped(
        t["absa"], base0 + js0 - 1, fs0, sp0, c.fac00, c.fac10, nsp)
    tmaj1 = sc1[..., None] * _major_9sp_clipped(
        t["absa"], base1 + js1 - 1, fs1, sp1, c.fac01, c.fac11, nsp)
    return tmaj0 + tmaj1


def _band_2sp_upper(t, c, band, col1, col2, rat0, rat1, mult=4.0):
    """Upper-atmosphere two-species (5-bin eta, linear interpolation)."""
    nsp = max(int(NSPB[band - 1]), 1)
    sc0, sp0, js0, fs0 = _spec(col1, rat0, col2, mult)
    sc1, sp1, js1, fs1 = _spec(col1, rat1, col2, mult)
    base0 = ((c.jp - 13) * 5 + (c.jt - 1)) * nsp
    base1 = ((c.jp - 12) * 5 + (c.jt1 - 1)) * nsp
    ind0 = base0 + js0 - 1
    ind1 = base1 + js1 - 1
    fA0, fB0 = c.fac00[..., None], c.fac10[..., None]
    fA1, fB1 = c.fac01[..., None], c.fac11[..., None]
    fs0e, fs1e = fs0[..., None], fs1[..., None]
    absb = t["absb"]
    tmaj0 = sc0[..., None] * (
        fA0 * ((1 - fs0e) * _g(absb, ind0) + fs0e * _g(absb, ind0 + 1))
        + fB0 * ((1 - fs0e) * _g(absb, ind0 + nsp)
                 + fs0e * _g(absb, ind0 + nsp + 1)))
    tmaj1 = sc1[..., None] * (
        fA1 * ((1 - fs1e) * _g(absb, ind1) + fs1e * _g(absb, ind1 + 1))
        + fB1 * ((1 - fs1e) * _g(absb, ind1 + nsp)
                 + fs1e * _g(absb, ind1 + nsp + 1)))
    return tmaj0 + tmaj1


def _planck_spec(col1, refrat, col2, mult, fracref):
    _, spp, jpl, fpl = _spec(col1, refrat, col2, mult)
    return _planck_eta(fracref, jpl, fpl)


def taumol(tables, c, wx):
    """Gas optical depth + Planck fractions for all 140 g-points
    (taumol + taugb1..16, ra_rrtmg_lw.f90:4714-7930).

    Returns taug, fracs with shape (nlay, N, 140)."""
    tropo = c.tropo[..., None]
    parts_tau, parts_frac = [], []

    # compile-time scalars -> host numpy copy (device CHI_MLS would be a
    # tracer inside a lax.cond branch)
    chi_np = np.asarray(_DATA["chi_mls"])

    def chi(i, j0):
        return float(chi_np[i, j0 - 1])

    def refrat(i1, i2, jref):
        return float(chi_np[i1, jref - 1] / chi_np[i2, jref - 1])

    # ---- band 1: h2o, minor n2 (lower+upper) --------------------------
    t = tables[0]
    tauself, taufor = _selffor(t, c)
    b0a, b1a = _ind_a(c, 1)
    b0b, b1b = _ind_b(c, 1)
    pp = c.pavel
    corradj_l = jnp.where(pp < 250.0, 1.0 - 0.15 * (250.0 - pp) / 154.4,
                          1.0)
    corradj_u = 1.0 - 0.15 * (pp / 95.6)
    scalen2 = c.colbrd * c.scaleminorn2
    taun2_l = scalen2[..., None] * _minor_t(t["ka_mn2"], c.indminor,
                                            c.minorfrac)
    taun2_u = scalen2[..., None] * _minor_t(t["kb_mn2"], c.indminor,
                                            c.minorfrac)
    tau_l = corradj_l[..., None] * (
        c.colh2o[..., None] * _major_1sp_c(t["absa"], b0a, b1a, c)
        + tauself + taufor + taun2_l)
    tau_u = corradj_u[..., None] * (
        c.colh2o[..., None] * _major_1sp_c(t["absb"], b0b, b1b, c)
        + taufor + taun2_u)
    parts_tau.append(jnp.where(tropo, tau_l, tau_u))
    parts_frac.append(jnp.where(tropo, t["fracrefa"], t["fracrefb"]))

    # ---- band 2: h2o ---------------------------------------------------
    t = tables[1]
    tauself, taufor = _selffor(t, c)
    b0a, b1a = _ind_a(c, 2)
    b0b, b1b = _ind_b(c, 2)
    corradj = 1.0 - 0.05 * (c.pavel - 100.0) / 900.0
    tau_l = corradj[..., None] * (
        c.colh2o[..., None] * _major_1sp_c(t["absa"], b0a, b1a, c)
        + tauself + taufor)
    tau_u = (c.colh2o[..., None] * _major_1sp_c(t["absb"], b0b, b1b, c)
             + taufor)
    parts_tau.append(jnp.where(tropo, tau_l, tau_u))
    parts_frac.append(jnp.where(tropo, t["fracrefa"], t["fracrefb"]))

    # ---- band 3: h2o+co2, minor n2o ------------------------------------
    t = tables[2]
    tauself, taufor = _selffor(t, c)
    tmaj_l = _band_2sp_lower(t, c, 3, c.colh2o, c.colco2,
                             c.rat.h2oco2, c.rat.h2oco2_1)
    tmaj_u = _band_2sp_upper(t, c, 3, c.colh2o, c.colco2,
                             c.rat.h2oco2, c.rat.h2oco2_1)
    # minor n2o with eta interpolation; 9 bins lower, 5 bins upper
    _, _, jmn2o_l, fmn2o_l = _spec(c.colh2o, refrat(0, 1, 3), c.colco2,
                                   8.0)
    _, _, jmn2o_u, fmn2o_u = _spec(c.colh2o, refrat(0, 1, 13), c.colco2,
                                   4.0)
    absn2o_l = _minor_eta(t["ka_mn2o"], jmn2o_l, fmn2o_l, c.indminor,
                          c.minorfrac)
    absn2o_u = _minor_eta(t["kb_mn2o"], jmn2o_u, fmn2o_u, c.indminor,
                          c.minorfrac)
    adjcoln2o = _adjcol(c.coln2o, c.coldry, c.jp, 3, 1.5, 0.5, 0.65)
    tau_l = tmaj_l + tauself + taufor \
        + adjcoln2o[..., None] * absn2o_l
    tau_u = tmaj_u + taufor + adjcoln2o[..., None] * absn2o_u
    fr_l = _planck_spec(c.colh2o, refrat(0, 1, 9), c.colco2, 8.0,
                        t["fracrefa"])
    fr_u = _planck_spec(c.colh2o, refrat(0, 1, 13), c.colco2, 4.0,
                        t["fracrefb"])
    parts_tau.append(jnp.where(tropo, tau_l, tau_u))
    parts_frac.append(jnp.where(tropo, fr_l, fr_u))

    # ---- band 4: h2o+co2 lower, o3+co2 upper ---------------------------
    t = tables[3]
    tauself, taufor = _selffor(t, c)
    tmaj_l = _band_2sp_lower(t, c, 4, c.colh2o, c.colco2,
                             c.rat.h2oco2, c.rat.h2oco2_1)
    tmaj_u = _band_2sp_upper(t, c, 4, c.colo3, c.colco2,
                             c.rat.o3co2, c.rat.o3co2_1)
    tau_l = tmaj_l + tauself + taufor
    # stratospheric empirical adjustments on g-points 8-14 (:5551-5557)
    adj = jnp.asarray([1.0] * 7 + [0.92, 0.88, 1.07, 1.1, 0.99, 0.88,
                                   0.943])
    tau_u = tmaj_u * adj
    fr_l = _planck_spec(c.colh2o, refrat(0, 1, 11), c.colco2, 8.0,
                        t["fracrefa"])
    fr_u = _planck_spec(c.colo3, refrat(2, 1, 13), c.colco2, 4.0,
                        t["fracrefb"])
    parts_tau.append(jnp.where(tropo, tau_l, tau_u))
    parts_frac.append(jnp.where(tropo, fr_l, fr_u))

    # ---- band 5: h2o+co2 lower (minor o3, ccl4), o3+co2 upper ----------
    t = tables[4]
    tauself, taufor = _selffor(t, c)
    tmaj_l = _band_2sp_lower(t, c, 5, c.colh2o, c.colco2,
                             c.rat.h2oco2, c.rat.h2oco2_1)
    tmaj_u = _band_2sp_upper(t, c, 5, c.colo3, c.colco2,
                             c.rat.o3co2, c.rat.o3co2_1)
    _, _, jmo3, fmo3 = _spec(c.colh2o, refrat(0, 1, 7), c.colco2, 8.0)
    abso3 = _minor_eta(t["ka_mo3"], jmo3, fmo3, c.indminor, c.minorfrac)
    tau_ccl4 = wx[0][..., None] * t["ccl4"]
    tau_l = tmaj_l + tauself + taufor \
        + c.colo3[..., None] * abso3 + tau_ccl4
    tau_u = tmaj_u + tau_ccl4
    fr_l = _planck_spec(c.colh2o, refrat(0, 1, 5), c.colco2, 8.0,
                        t["fracrefa"])
    fr_u = _planck_spec(c.colo3, refrat(2, 1, 43), c.colco2, 4.0,
                        t["fracrefb"])
    parts_tau.append(jnp.where(tropo, tau_l, tau_u))
    parts_frac.append(jnp.where(tropo, fr_l, fr_u))

    # ---- band 6: h2o lower (minor co2, cfc11, cfc12); nothing upper ----
    t = tables[5]
    tauself, taufor = _selffor(t, c)
    b0a, b1a = _ind_a(c, 6)
    adjcolco2 = _adjcol(c.colco2, c.coldry, c.jp, 1, 3.0, 2.0, 0.77)
    absco2 = _minor_t(t["ka_mco2"], c.indminor, c.minorfrac)
    tau_cfc = (wx[1][..., None] * t["cfc11adj"]
               + wx[2][..., None] * t["cfc12"])
    tau_l = (c.colh2o[..., None] * _major_1sp_c(t["absa"], b0a, b1a, c)
             + tauself + taufor + adjcolco2[..., None] * absco2
             + tau_cfc)
    tau_u = tau_cfc
    parts_tau.append(jnp.where(tropo, tau_l, tau_u))
    parts_frac.append(jnp.broadcast_to(t["fracrefa"], tau_l.shape))

    # ---- band 7: h2o+o3 lower (minor co2), o3 upper (minor co2) --------
    t = tables[6]
    tauself, taufor = _selffor(t, c)
    tmaj_l = _band_2sp_lower(t, c, 7, c.colh2o, c.colo3,
                             c.rat.h2oo3, c.rat.h2oo3_1)
    _, _, jmco2, fmco2 = _spec(c.colh2o, refrat(0, 2, 3), c.colo3, 8.0)
    absco2_l = _minor_eta(t["ka_mco2"], jmco2, fmco2, c.indminor,
                          c.minorfrac)
    adjco2_l = _adjcol(c.colco2, c.coldry, c.jp, 1, 3.0, 3.0, 0.79)
    adjco2_u = _adjcol(c.colco2, c.coldry, c.jp, 1, 3.0, 2.0, 0.79)
    absco2_u = _minor_t(t["kb_mco2"], c.indminor, c.minorfrac)
    b0b, b1b = _ind_b(c, 7)
    tau_l = tmaj_l + tauself + taufor + adjco2_l[..., None] * absco2_l
    adj7 = jnp.asarray([1.0] * 5 + [0.92, 0.88, 1.07, 1.1, 0.99, 0.855,
                                    1.0])
    tau_u = (c.colo3[..., None] * _major_1sp_c(t["absb"], b0b, b1b, c)
             + adjco2_u[..., None] * absco2_u) * adj7
    fr_l = _planck_spec(c.colh2o, refrat(0, 2, 3), c.colo3, 8.0,
                        t["fracrefa"])
    parts_tau.append(jnp.where(tropo, tau_l, tau_u))
    parts_frac.append(jnp.where(tropo, fr_l, t["fracrefb"]))

    # ---- band 8: h2o lower / o3 upper; minors co2,o3,n2o + cfcs --------
    t = tables[7]
    tauself, taufor = _selffor(t, c)
    b0a, b1a = _ind_a(c, 8)
    b0b, b1b = _ind_b(c, 8)
    adjco2 = _adjcol(c.colco2, c.coldry, c.jp, 1, 3.0, 2.0, 0.65)
    absco2_l = _minor_t(t["ka_mco2"], c.indminor, c.minorfrac)
    abso3_l = _minor_t(t["ka_mo3"], c.indminor, c.minorfrac)
    absn2o_l = _minor_t(t["ka_mn2o"], c.indminor, c.minorfrac)
    absco2_u = _minor_t(t["kb_mco2"], c.indminor, c.minorfrac)
    absn2o_u = _minor_t(t["kb_mn2o"], c.indminor, c.minorfrac)
    tau_cfc = (wx[2][..., None] * t["cfc12"]
               + wx[3][..., None] * t["cfc22adj"])
    tau_l = (c.colh2o[..., None] * _major_1sp_c(t["absa"], b0a, b1a, c)
             + tauself + taufor + adjco2[..., None] * absco2_l
             + c.colo3[..., None] * abso3_l
             + c.coln2o[..., None] * absn2o_l + tau_cfc)
    tau_u = (c.colo3[..., None] * _major_1sp_c(t["absb"], b0b, b1b, c)
             + adjco2[..., None] * absco2_u
             + c.coln2o[..., None] * absn2o_u + tau_cfc)
    parts_tau.append(jnp.where(tropo, tau_l, tau_u))
    parts_frac.append(jnp.where(tropo, t["fracrefa"], t["fracrefb"]))

    # ---- band 9: h2o+ch4 lower (minor n2o), ch4 upper (minor n2o) ------
    t = tables[8]
    tauself, taufor = _selffor(t, c)
    tmaj_l = _band_2sp_lower(t, c, 9, c.colh2o, c.colch4,
                             c.rat.h2och4, c.rat.h2och4_1)
    _, _, jmn2o, fmn2o = _spec(c.colh2o, refrat(0, 5, 3), c.colch4, 8.0)
    absn2o_l = _minor_eta(t["ka_mn2o"], jmn2o, fmn2o, c.indminor,
                          c.minorfrac)
    absn2o_u = _minor_t(t["kb_mn2o"], c.indminor, c.minorfrac)
    adjn2o = _adjcol(c.coln2o, c.coldry, c.jp, 3, 1.5, 0.5, 0.65)
    b0b, b1b = _ind_b(c, 9)
    tau_l = tmaj_l + tauself + taufor + adjn2o[..., None] * absn2o_l
    tau_u = (c.colch4[..., None] * _major_1sp_c(t["absb"], b0b, b1b, c)
             + adjn2o[..., None] * absn2o_u)
    fr_l = _planck_spec(c.colh2o, refrat(0, 5, 9), c.colch4, 8.0,
                        t["fracrefa"])
    parts_tau.append(jnp.where(tropo, tau_l, tau_u))
    parts_frac.append(jnp.where(tropo, fr_l, t["fracrefb"]))

    # ---- band 10: h2o both ---------------------------------------------
    t = tables[9]
    tauself, taufor = _selffor(t, c)
    b0a, b1a = _ind_a(c, 10)
    b0b, b1b = _ind_b(c, 10)
    tau_l = (c.colh2o[..., None] * _major_1sp_c(t["absa"], b0a, b1a, c)
             + tauself + taufor)
    tau_u = (c.colh2o[..., None] * _major_1sp_c(t["absb"], b0b, b1b, c)
             + taufor)
    parts_tau.append(jnp.where(tropo, tau_l, tau_u))
    parts_frac.append(jnp.where(tropo, t["fracrefa"], t["fracrefb"]))

    # ---- band 11: h2o both, minor o2 -----------------------------------
    t = tables[10]
    tauself, taufor = _selffor(t, c)
    b0a, b1a = _ind_a(c, 11)
    b0b, b1b = _ind_b(c, 11)
    scaleo2 = (c.colo2 * c.scaleminor)[..., None]
    tauo2_l = scaleo2 * _minor_t(t["ka_mo2"], c.indminor, c.minorfrac)
    tauo2_u = scaleo2 * _minor_t(t["kb_mo2"], c.indminor, c.minorfrac)
    tau_l = (c.colh2o[..., None] * _major_1sp_c(t["absa"], b0a, b1a, c)
             + tauself + taufor + tauo2_l)
    tau_u = (c.colh2o[..., None] * _major_1sp_c(t["absb"], b0b, b1b, c)
             + taufor + tauo2_u)
    parts_tau.append(jnp.where(tropo, tau_l, tau_u))
    parts_frac.append(jnp.where(tropo, t["fracrefa"], t["fracrefb"]))

    # ---- band 12: h2o+co2 lower; nothing upper -------------------------
    t = tables[11]
    tauself, taufor = _selffor(t, c)
    tmaj_l = _band_2sp_lower(t, c, 12, c.colh2o, c.colco2,
                             c.rat.h2oco2, c.rat.h2oco2_1)
    tau_l = tmaj_l + tauself + taufor
    fr_l = _planck_spec(c.colh2o, refrat(0, 1, 10), c.colco2, 8.0,
                        t["fracrefa"])
    parts_tau.append(jnp.where(tropo, tau_l, jnp.zeros_like(tau_l)))
    parts_frac.append(jnp.where(tropo, fr_l, jnp.zeros_like(fr_l)))

    # ---- band 13: h2o+n2o lower (minors co2, co); o3 minor upper -------
    t = tables[12]
    tauself, taufor = _selffor(t, c)
    tmaj_l = _band_2sp_lower(t, c, 13, c.colh2o, c.coln2o,
                             c.rat.h2on2o, c.rat.h2on2o_1)
    _, _, jmco2, fmco2 = _spec(c.colh2o, refrat(0, 3, 1), c.coln2o, 8.0)
    absco2 = _minor_eta(t["ka_mco2"], jmco2, fmco2, c.indminor,
                        c.minorfrac)
    adjco2 = _adjcol(c.colco2, c.coldry, c.jp, 1, 3.0, 2.0, 0.68,
                     chi_ref=3.55e-4)
    _, _, jmco, fmco = _spec(c.colh2o, refrat(0, 3, 3), c.coln2o, 8.0)
    absco = _minor_eta(t["ka_mco"], jmco, fmco, c.indminor, c.minorfrac)
    tau_l = tmaj_l + tauself + taufor \
        + adjco2[..., None] * absco2 + c.colco[..., None] * absco
    abso3_u = _minor_t(t["kb_mo3"], c.indminor, c.minorfrac)
    tau_u = c.colo3[..., None] * abso3_u
    fr_l = _planck_spec(c.colh2o, refrat(0, 3, 5), c.coln2o, 8.0,
                        t["fracrefa"])
    parts_tau.append(jnp.where(tropo, tau_l, tau_u))
    parts_frac.append(jnp.where(tropo, fr_l, t["fracrefb"]))

    # ---- band 14: co2 both ----------------------------------------------
    t = tables[13]
    tauself, taufor = _selffor(t, c)
    b0a, b1a = _ind_a(c, 14)
    b0b, b1b = _ind_b(c, 14)
    tau_l = (c.colco2[..., None] * _major_1sp_c(t["absa"], b0a, b1a, c)
             + tauself + taufor)
    tau_u = c.colco2[..., None] * _major_1sp_c(t["absb"], b0b, b1b, c)
    parts_tau.append(jnp.where(tropo, tau_l, tau_u))
    parts_frac.append(jnp.where(tropo, t["fracrefa"], t["fracrefb"]))

    # ---- band 15: n2o+co2 lower (minor n2); nothing upper ---------------
    t = tables[14]
    tauself, taufor = _selffor(t, c)
    tmaj_l = _band_2sp_lower(t, c, 15, c.coln2o, c.colco2,
                             c.rat.n2oco2, c.rat.n2oco2_1)
    _, _, jmn2, fmn2 = _spec(c.coln2o, refrat(3, 1, 1), c.colco2, 8.0)
    absn2 = _minor_eta(t["ka_mn2"], jmn2, fmn2, c.indminor, c.minorfrac)
    scalen2 = (c.colbrd * c.scaleminor)[..., None]
    tau_l = tmaj_l + tauself + taufor + scalen2 * absn2
    fr_l = _planck_spec(c.coln2o, refrat(3, 1, 1), c.colco2, 8.0,
                        t["fracrefa"])
    parts_tau.append(jnp.where(tropo, tau_l, jnp.zeros_like(tau_l)))
    parts_frac.append(jnp.where(tropo, fr_l, jnp.zeros_like(fr_l)))

    # ---- band 16: h2o+ch4 lower, ch4 upper -------------------------------
    t = tables[15]
    tauself, taufor = _selffor(t, c)
    tmaj_l = _band_2sp_lower(t, c, 16, c.colh2o, c.colch4,
                             c.rat.h2och4, c.rat.h2och4_1)
    tau_l = tmaj_l + tauself + taufor
    # NOTE reference quirk preserved: nspb(16) = 0 collapses the upper
    # index to absb row 1 regardless of (jp, jt)
    # (lwdatinit :8078, taugb16 :7880-7890)
    z16 = jnp.zeros_like(c.jp)
    tau_u = c.colch4[..., None] * _major_1sp_c(t["absb"], z16, z16, c)
    fr_l = _planck_spec(c.colh2o, refrat(0, 5, 6), c.colch4, 8.0,
                        t["fracrefa"])
    fr_u = t["fracrefb"]
    parts_tau.append(jnp.where(tropo, tau_l, tau_u))
    parts_frac.append(jnp.where(tropo, fr_l, fr_u))

    # clamp: T-extrapolation outside the k-table range can yield negative
    # gas optical depth (transmittance > 1); the reference does not guard
    # this.  Deliberate robustness divergence (see rrtmg_sw.taumol_sw).
    taug = jnp.maximum(jnp.concatenate(parts_tau, axis=-1), 0.0)
    fracs = jnp.concatenate(parts_frac, axis=-1)
    return taug, fracs


# ==========================================================================
# McICA subcolumn cloud sampling (mcica_subcol_lw; jax PRNG variant)
# ==========================================================================

def mcica_subcol_lw(key, cldfrac, ciwp, clwp, cswp, icld=1):
    """Stochastic subcolumn cloud generator. cldfrac etc. (nlay, N);
    returns per-g-point binary cloud masks and in-cloud water paths
    (ngpt, nlay, N) equivalents stored as (nlay, N, ngpt).

    icld=1: random overlap; icld=2: maximum-random (the reference's
    generate_stochastic_clouds); jax PRNG replaces the KISS generator."""
    nlay, N = cldfrac.shape
    shape = (nlay, N, NGPTLW)
    cdf = jax.random.uniform(key, shape, jnp.float32)
    if icld >= 2:
        # maximum-random: reuse the layer-above draw where it was cloudy
        def body(carry, x):
            cdf_above = carry
            cdf_lay, cf_above = x
            new = jnp.where(cdf_above > 1.0 - cf_above[..., None],
                            cdf_above, cdf_lay)
            return new, new
        # scan from top (last layer) down as in the reference generator
        cdf_rev = cdf[::-1]
        cf_rev = cldfrac[::-1]
        _, out = jax.lax.scan(body, cdf_rev[0],
                              (cdf_rev, jnp.roll(cf_rev, 1, axis=0)))
        cdf = out[::-1]
    cldy = cdf > (1.0 - cldfrac[..., None])
    cldfmc = cldy.astype(jnp.float32)
    ciwpmc = jnp.where(cldy, ciwp[..., None], 0.0)
    clwpmc = jnp.where(cldy, clwp[..., None], 0.0)
    cswpmc = jnp.where(cldy, cswp[..., None], 0.0)
    return cldfmc, ciwpmc, clwpmc, cswpmc


# ==========================================================================
# cloud optical depths (cldprmc, ra_rrtmg_lw.f90:2673-2968)
# ==========================================================================

def cldprmc(cldfmc, ciwpmc, clwpmc, cswpmc, rei, rel, res):
    """In-cloud LW optical depth per g-point; inflag>=2, iceflag=4
    (Fu generalized effective size via absice3), liqflag=1 (Hu & Stamnes
    via absliq1), snow path treated with the ice coefficients as in
    iceflag=5 handling."""
    ngb0 = jnp.asarray(NGB - 1)        # band index per g-point, 0-based

    radice = jnp.clip(rei, 5.0, 140.0)
    factor = (radice - 2.0) / 3.0
    index = jnp.clip(factor.astype(jnp.int32), 1, 45)
    fint = factor - index.astype(jnp.float32)
    a3 = ABSICE3[:, ngb0]             # (46, ngpt)
    i0 = index - 1
    absco_ice = (a3[i0] + fint[..., None]
                 * (a3[i0 + 1] - a3[i0]))       # (..., ngpt) via gather
    # NOTE a3[i0]: i0 is (nlay, N) -> result (nlay, N, ngpt)

    radsno = jnp.clip(res, 5.0, 140.0)
    fs_ = (radsno - 2.0) / 3.0
    is_ = jnp.clip(fs_.astype(jnp.int32), 1, 45)
    fints = fs_ - is_.astype(jnp.float32)
    absco_sno = (a3[is_ - 1] + fints[..., None]
                 * (a3[is_] - a3[is_ - 1]))

    radliq = jnp.clip(rel, 2.5, 60.0)
    il = jnp.clip((radliq - 1.5).astype(jnp.int32), 1, 57)
    fintl = radliq - 1.5 - il.astype(jnp.float32)
    l1 = ABSLIQ1[:, ngb0]             # (58, ngpt)
    absco_liq = (l1[il - 1] + fintl[..., None]
                 * (l1[il] - l1[il - 1]))

    taucmc = (ciwpmc * absco_ice + clwpmc * absco_liq
              + cswpmc * absco_sno)
    cwp = ciwpmc + clwpmc + cswpmc
    active = (cldfmc >= 1e-20) & (cwp >= 1e-20)
    return jnp.where(active, taucmc, 0.0)


# ==========================================================================
# radiative transfer (rtrnmc, ra_rrtmg_lw.f90:2972-3458)
# ==========================================================================

def rtrnmc(semiss_bnd, pwvcm, cldfmc, taucmc, planklay, planklev,
           plankbnd, fracs, taut):
    """Upward/downward LW fluxes with McICA cloud sampling.

    Shapes: taut/fracs/cldfmc/taucmc (nlay, N, ngpt); planklay
    (nlay, N, 16); planklev (nlay+1, N, 16); plankbnd/semiss_bnd (N, 16).
    Returns (totuflux, totdflux, totuclfl, totdclfl) at (nlay+1, N)."""
    nlay, N, _ = taut.shape
    ngb0 = np.asarray(NGB - 1)

    a0 = jnp.asarray(SECDIFF_A0)
    a1 = jnp.asarray(SECDIFF_A1)
    a2 = jnp.asarray(SECDIFF_A2)
    sec = a0[None] + a1[None] * jnp.exp(a2[None] * pwvcm[:, None])
    sec = jnp.clip(sec, 1.50, 1.80)
    fixed = jnp.asarray([True, False, False, True, False, False, False,
                         False, False] + [True] * 7)
    secdiff = jnp.where(fixed[None], 1.66, sec)      # (N, 16)
    secg = secdiff[:, ngb0]                          # (N, ngpt)

    # per-g-point band Planck values
    planklay_g = planklay[:, :, ngb0]                # (nlay, N, ngpt)
    planklev_g = planklev[:, :, ngb0]                # (nlay+1, N, ngpt)
    plankbnd_g = plankbnd[:, ngb0]                   # (N, ngpt)

    odepth = jnp.maximum(secg[None] * taut, 0.0)
    odcld = secg[None] * taucmc
    cloudy = cldfmc == 1.0
    abscld = jnp.where(cloudy, 1.0 - jnp.exp(-odcld), 0.0)
    efclfrac = abscld * cldfmc
    icldlyr = jnp.any(cloudy, axis=-1)               # (nlay, N)

    odtot = odepth + jnp.where(cloudy, odcld, 0.0)
    atrans = 1.0 - jnp.exp(-odepth)
    atot = 1.0 - jnp.exp(-odtot)
    tfacgas = _tfn(odepth)
    tfactot = _tfn(odtot)

    blay = planklay_g
    dplankup = planklev_g[1:] - blay
    dplankdn = planklev_g[:-1] - blay
    bbdgas = fracs * (blay + tfacgas * dplankdn)     # downward gas source
    bbugas_ = fracs * (blay + tfacgas * dplankup)    # upward gas source
    bbdtot = fracs * (blay + tfactot * dplankdn)
    bbutot_ = fracs * (blay + tfactot * dplankup)
    gassrc_dn = bbdgas * atrans

    # downward sweep (surface-directed), from the top layer
    def down_body(carry, x):
        radld, radclrd, iclddn = carry
        (atrans_l, atot_l, efcl_l, cldf_l, gsrc_l, bbdtot_l, bbd_l,
         cld_l) = x
        rad_cld = (radld - radld * (atrans_l + efcl_l * (1.0 - atrans_l))
                   + gsrc_l + cldf_l * (bbdtot_l * atot_l - gsrc_l))
        rad_clr = radld + (bbd_l - radld) * atrans_l
        radld_new = jnp.where(cld_l, rad_cld, rad_clr)
        iclddn = iclddn | cld_l
        radclrd_new = jnp.where(iclddn,
                                radclrd + (bbd_l - radclrd) * atrans_l,
                                radld_new)
        return (radld_new, radclrd_new, iclddn), (radld_new, radclrd_new)

    cld_g = icldlyr[..., None] & jnp.ones_like(cloudy)
    xs = (atrans[::-1], atot[::-1], efclfrac[::-1], cldfmc[::-1],
          gassrc_dn[::-1], bbdtot[::-1], bbdgas[::-1], cld_g[::-1])
    zero = jnp.zeros((N, NGPTLW), jnp.float32)
    (_, _, _), (drad_rev, dclr_rev) = jax.lax.scan(
        down_body, (zero, zero, jnp.zeros((N, NGPTLW), bool)), xs)
    drad = drad_rev[::-1]          # (nlay, N, ngpt): down radiance at lev-1
    dclr = dclr_rev[::-1]

    # surface reflection + upward sweep
    rad0 = fracs[0] * plankbnd_g
    semiss_g = semiss_bnd[:, ngb0]
    reflect = 1.0 - semiss_g
    radld_sfc = drad[0]
    radclrd_sfc = dclr[0]
    radlu0 = rad0 + reflect * radld_sfc
    radclru0 = rad0 + reflect * radclrd_sfc

    def up_body(carry, x):
        radlu, radclru = carry
        atrans_l, atot_l, efcl_l, cldf_l, bbu_l, bbut_l, cld_l = x
        gassrc = bbu_l * atrans_l
        rad_cld = (radlu - radlu * (atrans_l + efcl_l * (1.0 - atrans_l))
                   + gassrc + cldf_l * (bbut_l * atot_l - gassrc))
        rad_clr = radlu + (bbu_l - radlu) * atrans_l
        radlu_new = jnp.where(cld_l, rad_cld, rad_clr)
        radclru_new = radclru + (bbu_l - radclru) * atrans_l
        return (radlu_new, radclru_new), (radlu_new, radclru_new)

    xs_up = (atrans, atot, efclfrac, cldfmc, bbugas_, bbutot_, cld_g)
    (_, _), (urad_lay, uclr_lay) = jax.lax.scan(
        up_body, (radlu0, radclru0), xs_up)

    # band-integrated fluxes (wtdiff * delwave summed over g-points)
    delw_g = jnp.asarray(DELWAVE)[ngb0]

    def flux(rad):
        return jnp.sum(rad * WTDIFF * delw_g, axis=-1) * FLUXFAC

    totuflux = jnp.concatenate([flux(radlu0)[None],
                                flux(urad_lay.reshape(nlay, N, NGPTLW))],
                               axis=0)
    totuclfl = jnp.concatenate([flux(radclru0)[None],
                                flux(uclr_lay.reshape(nlay, N, NGPTLW))],
                               axis=0)
    dflux_levs = jnp.concatenate([drad, jnp.zeros((1, N, NGPTLW))],
                                 axis=0)
    dclr_levs = jnp.concatenate([dclr, jnp.zeros((1, N, NGPTLW))],
                                axis=0)
    totdflux = flux(dflux_levs.reshape(nlay + 1, N, NGPTLW))
    totdclfl = flux(dclr_levs.reshape(nlay + 1, N, NGPTLW))
    return totuflux, totdflux, totuclfl, totdclfl


# ==========================================================================
# profile construction + top-level driver (inatm + rrtmg_lw + the WRF
# rrtmg_lwrad wrapper, ra_rrtmg_lw.f90:10600-12800)
# ==========================================================================

# climatological ozone profile (O3DATA, ra_rrtmg_lw.f90:12808-12870):
# annual mean of the summer/winter profiles on PPSUM/PPWIN levels
_O3SUM = np.array([5.297e-8, 5.852e-8, 6.579e-8, 7.505e-8, 8.577e-8,
                   9.895e-8, 1.175e-7, 1.399e-7, 1.677e-7, 2.003e-7,
                   2.571e-7, 3.325e-7, 4.438e-7, 6.255e-7, 8.168e-7,
                   1.036e-6, 1.366e-6, 1.855e-6, 2.514e-6, 3.240e-6,
                   4.033e-6, 4.854e-6, 5.517e-6, 6.089e-6, 6.689e-6,
                   1.106e-5, 1.462e-5, 1.321e-5, 9.856e-6, 5.960e-6,
                   5.960e-6])
_PPSUM = np.array([955.890, 850.532, 754.599, 667.742, 589.841, 519.421,
                   455.480, 398.085, 347.171, 301.735, 261.310, 225.360,
                   193.419, 165.490, 141.032, 120.125, 102.689, 87.829,
                   75.123, 64.306, 55.086, 47.209, 40.535, 34.795,
                   29.865, 19.122, 9.277, 4.660, 2.421, 1.294, 0.647])


def _o3_profile(pavel_hpa):
    """Interpolate the climatological O3 mass mixing ratio onto layer
    pressures (O3DATA + the wrapper's o3 fill; annual-mean profile)."""
    logp_ref = jnp.log(jnp.asarray(_PPSUM[::-1].copy()))
    o3_ref = jnp.asarray(_O3SUM[::-1].copy())
    lp = jnp.log(jnp.clip(pavel_hpa, float(_PPSUM[-1]),
                          float(_PPSUM[0])))
    return jnp.interp(lp, logp_ref, o3_ref)


def rrtmg_lw_rad(tables, play, plev, tlay, tlev, tsfc, h2ovmr, o3vmr,
                 cldfrac, ciwp, clwp, cswp, rei, rel, res, emis, key,
                 icld=1, co2vmr=CO2VMR, n2ovmr=N2OVMR, ch4vmr=CH4VMR,
                 cfc11vmr=CFC11VMR, cfc12vmr=CFC12VMR, cfc22vmr=CFC22VMR,
                 ccl4vmr=CCL4VMR):
    """Full LW calculation on (nlay, N) columns.

    play/tlay: (nlay, N) layer pressure [hPa] / temperature [K];
    plev/tlev: (nlay+1, N) interfaces (index 0 = surface); water paths in
    g/m2; effective radii in microns; emis (N,). Returns a namespace with
    fluxes (nlay+1, N) and heating rate (nlay, N) [K/day]."""
    # device-resident tables: numpy tables gathered with traced indices
    # fail under jit, so convert once here
    tables = jax.tree_util.tree_map(jnp.asarray, tables)
    nlay, N = play.shape
    # dry-air column (molecules/cm2), as in inatm (:10940-10960)
    dpg = (plev[:-1] - plev[1:])      # hPa, positive
    coldry = dpg * 1e3 * AVOGAD / (1e2 * GRAV * AMD * (1.0 + h2ovmr
                                                       * AMW / AMD))
    wkl = jnp.stack([
        h2ovmr * coldry, co2vmr * coldry, o3vmr * coldry,
        n2ovmr * coldry, jnp.zeros_like(coldry),     # CO neglected
        ch4vmr * coldry, O2VMR * coldry])
    wbroad = coldry * (1.0 - (h2ovmr + co2vmr + o3vmr + n2ovmr + ch4vmr
                              + O2VMR))
    # CFC/CCl4 cross-section amounts (inatm, :11331-11381)
    wx = [ccl4vmr * coldry * 1e-20, cfc11vmr * coldry * 1e-20,
          cfc12vmr * coldry * 1e-20, cfc22vmr * coldry * 1e-20]

    # precipitable water (cm) for the diffusivity angle
    amttl = jnp.sum(wkl[0], axis=0)
    pwvcm = amttl * (AMW / AVOGAD) / 0.9982      # cm (rho_w ~ 0.998)

    semiss = jnp.broadcast_to(emis[:, None], (N, 16))
    c = setcoef(play, tlay, tlev, tsfc, semiss, coldry, wkl, wbroad)
    taug, fracs = taumol(tables, c, wx)

    cldfmc, ciwpmc, clwpmc, cswpmc = mcica_subcol_lw(
        key, cldfrac, ciwp, clwp, cswp, icld)
    taucmc = cldprmc(cldfmc, ciwpmc, clwpmc, cswpmc, rei, rel, res)

    uf, df, ufc, dfc = rtrnmc(semiss, pwvcm, cldfmc, taucmc, c.planklay,
                              c.planklev, c.plankbnd, fracs, taug)
    # heating rate (K/day) from flux divergence (rtrnmc tail :3440-3450)
    fnet = uf - df
    htr = HEATFAC * (fnet[:-1] - fnet[1:]) / dpg
    return SimpleNamespace(uflx=uf, dflx=df, uflxc=ufc, dflxc=dfc,
                           htr=htr, glw=df[0], olr=uf[-1])


# number of columns per RRTMG invocation: the scheme materializes
# (nlay, ncol, ngpt) g-point intermediates — >1 GB of bool temps alone
# for a whole 500^2 domain in one call. The reference runs
# column-by-column (ra_rrtmg_lw.f90 i/j loops); here columns are
# processed in chunks via lax.map, so peak temp memory scales with the
# chunk: 16384 columns keep the temporaries to a few GB, a small share
# of the 60 GB JAX reserves on an 80 GB H100, while each chunk still
# fills the card. Single-chunk calls (N <= chunk) are bitwise identical
# to the unchunked formulation (same key, no split).
RRTMG_COL_CHUNK = 16384


def column_chunked(fn, key, cols, n, chunk):
    """Run ``fn(chunk_key, *col_chunks) -> dict`` over column chunks.

    ``cols``: arrays whose LAST axis is the column axis (1D or 2D);
    outputs are concatenated back on the column axis. Each chunk gets
    its own PRNG key (McICA cloud-overlap sampling is stochastic per
    column anyway)."""
    import jax

    if n <= chunk:
        return fn(key, *cols)
    C = -(-n // chunk)
    npad = C * chunk - n

    def split(a):
        a = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, npad)],
                    mode="edge")
        if a.ndim == 1:
            return a.reshape(C, chunk)
        return jnp.moveaxis(a.reshape(a.shape[0], C, chunk), 1, 0)

    stacked = tuple(split(a) for a in cols)
    keys = jax.random.split(key, C)
    out = jax.lax.map(lambda args: fn(args[0], *args[1:]),
                      (keys,) + stacked)

    def merge(a):
        if a.ndim == 2:
            return a.reshape(C * chunk)[:n]
        return jnp.moveaxis(a, 0, 1).reshape(a.shape[1],
                                             C * chunk)[:, :n]

    return {k: merge(v) for k, v in out.items()}


def rrtmg_lw_driver(tables, key, p3d, p8w, t3d, t8w, tsk, qv3d, qc3d,
                    qi3d, qs3d, cldfra3d, re_cloud, re_ice, re_snow,
                    rho3d, dz8w, emiss, exner, xland=None,
                    snow_optics=False, ghg=None):
    """ICAR-facing wrapper (RRTMG_LWRAD, ra_rrtmg_lw.f90:10600-12800):
    (z, y, x) fields -> column arrays, unit conversions, cloud water
    paths, effective-radius floors -> rrtmg_lw_rad -> theta tendency.

    Returns (th_tendency [K/s on theta], glw, olr, lwcf)."""
    nz, ny, nx = p3d.shape
    N = ny * nx
    flat = lambda a: a.reshape(a.shape[0], N)
    play = flat(p3d) / 100.0
    tlay = flat(t3d)
    # interfaces: p8w is the interface below each layer; add model top
    ptop = jnp.maximum(2.0 * p3d[-1] - p8w[-1], p8w[-1] * 0.5)
    plev = jnp.concatenate([flat(p8w), flat(ptop[None])], axis=0) / 100.0
    ttop = 2.0 * t3d[-1] - t8w[-1]
    tlev = jnp.concatenate([flat(t8w), flat(ttop[None])], axis=0)
    tsfc = tsk.reshape(N)
    h2ovmr = flat(qv3d) * (AMD / AMW)
    o3vmr = _o3_profile(play) * (AMD / 47.9982)   # mass mr -> vmr

    # in-cloud condensed water paths (g/m2) with cloud-fraction scaling
    cf = jnp.clip(flat(cldfra3d), 0.0, 1.0)
    gwp = lambda q: jnp.where(
        cf > 0.0, 1000.0 * flat(q * rho3d * dz8w) / jnp.maximum(cf, 1e-3),
        0.0)
    clwp = gwp(qc3d)
    ciwp = gwp(qi3d)
    # NOTE reference quirk preserved: a de-commented "mp option=5" block
    # in the wrapper (ra_rrtmg_lw.f90:12082-12088) unconditionally zeroes
    # qs1d, so snow never contributes to the LW cloud optics there.
    cswp = gwp(qs3d) if snow_optics else jnp.zeros_like(clwp)

    # effective radii in microns with the WRF floors (:12115-12190);
    # rel <= 2.5 um inside cloud falls back to 10.5 (ocean) / 7.5 (land)
    rel = jnp.maximum(2.5, flat(re_cloud) * 1e6)
    rel_fb = 7.5 if xland is None else jnp.where(
        xland.reshape(N)[None] > 1.5, 10.5, 7.5)
    rel = jnp.where((rel <= 2.5) & (cf > 0.0), rel_fb, rel)
    rei = jnp.maximum(5.0, flat(re_ice) * 1e6)
    res = jnp.maximum(10.0, flat(re_snow) * 1e6)

    gkw = {} if ghg is None else dict(
        co2vmr=ghg.co2, n2ovmr=ghg.n2o, ch4vmr=ghg.ch4,
        cfc11vmr=ghg.cfc11, cfc12vmr=ghg.cfc12)

    def _rad_chunk(k, play, plev, tlay, tlev, tsfc, h2o, o3, cfc, ciw,
                   clw, csw, rei_c, rel_c, res_c, em):
        o = rrtmg_lw_rad(tables, play, plev, tlay, tlev, tsfc, h2o, o3,
                         cfc, ciw, clw, csw, rei_c, rel_c, res_c, em,
                         k, **gkw)
        # LWCF = clear-sky OLR minus all-sky OLR (ra_rrtmg_lw.f90:12731)
        return dict(htr=o.htr, glw=o.glw, olr=o.olr,
                    lwcf=o.uflxc[-1] - o.uflx[-1])

    out = column_chunked(
        _rad_chunk, key,
        (play, plev, tlay, tlev, tsfc, h2ovmr, o3vmr, cf, ciwp, clwp,
         cswp, rei, rel, res, emiss.reshape(N)), N, RRTMG_COL_CHUNK)
    # tendency on potential temperature (rthratenlw = htr/86400/pii)
    th_tend = (out["htr"] / 86400.0).reshape(nz, ny, nx) / exner
    glw = out["glw"].reshape(ny, nx)
    olr = out["olr"].reshape(ny, nx)
    lwcf = out["lwcf"].reshape(ny, nx)
    return th_tend, glw, olr, lwcf


# --------------------------------------------------------------------------
# table resolution for model runs (rrtmg_lwinit, ra_driver.f90:67-75)
# --------------------------------------------------------------------------

_TABLES = None


def set_lw_tables(tables):
    """Inject k-distribution tables (tests use synthetic_lw_tables)."""
    global _TABLES
    _TABLES = tables


def get_lw_tables(support_dir="rrtmg_support"):
    """Tables for a model run: whatever was injected via set_lw_tables,
    else loaded (and cached) from the rrtmg_support data directory."""
    global _TABLES
    if _TABLES is None:
        from .rrtmg_lw_tables import load_lw_tables
        try:
            _TABLES = load_lw_tables(support_dir)
        except (FileNotFoundError, OSError) as e:
            raise FileNotFoundError(
                f"RRTMG k-distribution data not found in '{support_dir}'. "
                "rad=3 needs the external rrtmg_support files the "
                "reference also downloads separately (set "
                "rad_parameters/rrtmg_support_dir). Tests can inject "
                "synthetic tables: icar_tpu.physics.rrtmg_lw."
                "set_lw_tables(rrtmg_lw_tables.synthetic_lw_tables())."
            ) from e
    return _TABLES
