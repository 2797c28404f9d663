"""RRTMG shortwave radiation (rad=3, use_simple_sw=false), in JAX.

Re-implementation of rrtmg_sw (/root/reference/src/physics/ra_rrtmg_sw.f90,
AER's RRTMG-SW v3.7 as carried by WRF/ICAR): correlated-k gas optics over
14 bands / 112 g-points, McICA cloud sampling, delta-scaled two-stream
(PIFM, Zdunkowski) reflectance/transmittance per layer and vertical adding
(spcvmc_sw + reftra_sw + vrtqdr_sw).

Differences from the reference, all deliberate:
  * per-column and per-g-point vectorization — the column loop, band loop
    and g-point loop all become array axes; the two vertical adding scans
    are lax.scan;
  * exp() is evaluated directly instead of the exp_tbl lookup table
    (a scalar-CPU optimization; a table lookup costs more than exp on a
    vector machine);
  * out-of-range effective radii are CLIPPED into the table range where
    the reference `error stop`s (cldprmc_sw radius bounds).  This is not
    academic: the wrapper forces re_snow=500 um whenever mp_options /= 5
    (ra_rrtmg_sw.f90:10648) and ICAR hardcodes mp_options=0
    (ra_driver.f90:246), so the reference would hard-crash on the first
    snowy cloudy subcolumn — we clip to 140 um instead;
  * night columns are computed with the zepzen floor and masked to zero
    afterwards, rather than skipped (static shapes for XLA).

The k-distribution data come from the same external rrtmg_support/*_sw.nc
files the reference reads (not shipped with either repository); tests run
on synthetic tables (rrtmg_sw_tables.synthetic_sw_tables).
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp

from ..ops.indexing import take_level
import numpy as np

from .rrtmg_lw import (AMD, AMW, AVOGAD, GRAV, HEATFAC, ONEMINUS, PREFLOG,
                       TREF, CO2VMR, N2OVMR, CH4VMR, O2VMR, _o3_profile)
from .rrtmg_sw_tables import NBANDS, NGPTSW, NGC, NGS, NGB, NSPA, NSPB

_DATA = np.load(os.path.join(os.path.dirname(__file__), "data",
                             "rrtmg_sw_data.npz"))
EXTLIQ1 = jnp.asarray(_DATA["extliq1"])     # (58, 14)
SSALIQ1 = jnp.asarray(_DATA["ssaliq1"])
ASYLIQ1 = jnp.asarray(_DATA["asyliq1"])
EXTICE3 = jnp.asarray(_DATA["extice3"])     # (46, 14)
SSAICE3 = jnp.asarray(_DATA["ssaice3"])
ASYICE3 = jnp.asarray(_DATA["asyice3"])
FDLICE3 = jnp.asarray(_DATA["fdlice3"])

RRSW_SCON = 1368.22        # internal solar constant (rrsw_con :115)
ZEPZEN = 1e-10             # zenith cosine floor (rrtmg_sw :9291)
CLDMIN = 1e-20             # cldprmc_sw threshold
REPCLC = 1e-12             # spcvmc cloud fraction epsilon
NGB0 = jnp.asarray(NGB - 1)            # 0-based band per g-point

# ==========================================================================
# setcoef (setcoef_sw, ra_rrtmg_sw.f90:2767-3023)
# ==========================================================================


def setcoef_sw(pavel, tavel, coldry, wkl):
    """Pressure/temperature interpolation indices + column amounts.
    pavel/tavel (nlay, N); wkl (7, nlay, N).  All jp/jt 1-based values
    as in the Fortran; tables are gathered 0-based downstream."""
    stpfac = 296.0 / 1013.0
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
    tropo = plog > 4.56

    forfac = scalefac / (1.0 + water)
    factor_t = (332.0 - tavel) / 36.0
    indfor = jnp.where(
        tropo, jnp.clip(jnp.floor(factor_t).astype(jnp.int32), 1, 2), 3)
    forfrac = jnp.where(tropo, factor_t - indfor.astype(jnp.float32),
                        (tavel - 188.0) / 36.0 - 1.0)
    selffac = water * forfac
    factor_s = (tavel - 188.0) / 7.2
    indself = jnp.clip(jnp.floor(factor_s).astype(jnp.int32) - 7, 1, 9)
    selffrac = factor_s - (indself + 7).astype(jnp.float32)

    def col(i):
        c = 1e-20 * wkl[i]
        return jnp.where(c == 0.0, 1e-32 * coldry, c)

    colh2o = 1e-20 * wkl[0]
    colmol = 1e-20 * coldry + colh2o

    compfp = 1.0 - fp
    return SimpleNamespace(
        tropo=tropo, jp=jp, jt=jt, jt1=jt1,
        fac10=compfp * ft, fac00=compfp * (1.0 - ft),
        fac11=fp * ft1, fac01=fp * (1.0 - ft1),
        forfac=colh2o * forfac, forfrac=forfrac, indfor=indfor,
        selffac=colh2o * selffac, selffrac=selffrac, indself=indself,
        colh2o=colh2o, colco2=col(1), colo3=col(2), coln2o=col(3),
        colch4=col(5), colo2=col(6), colmol=colmol, pavel=pavel)


# ==========================================================================
# taumol (taumol_sw + taugb16..29, ra_rrtmg_sw.f90:3114-4574)
# ==========================================================================

def _g(table, idx):
    return table[jnp.clip(idx, 0, table.shape[0] - 1)]


def _spec(col1, rat, col2, mult):
    speccomb = col1 + rat * col2
    specparm = jnp.minimum(col1 / speccomb, ONEMINUS)
    specmult = mult * specparm
    js = 1 + jnp.floor(specmult).astype(jnp.int32)
    fs = jnp.mod(specmult, 1.0)
    return speccomb, js, fs


def _ind_a(c, band, js=1):
    nsp = max(int(NSPA[band - 1]), 1)
    ind0 = ((c.jp - 1) * 5 + (c.jt - 1)) * nsp + js - 1
    ind1 = (c.jp * 5 + (c.jt1 - 1)) * nsp + js - 1
    return ind0, ind1


def _ind_b(c, band, js=1):
    nsp = max(int(NSPB[band - 1]), 1)
    ind0 = ((c.jp - 13) * 5 + (c.jt - 1)) * nsp + js - 1
    ind1 = ((c.jp - 12) * 5 + (c.jt1 - 1)) * nsp + js - 1
    return ind0, ind1


def _major_1sp(table, ind0, ind1, c):
    return (c.fac00[..., None] * _g(table, ind0)
            + c.fac10[..., None] * _g(table, ind0 + 1)
            + c.fac01[..., None] * _g(table, ind1)
            + c.fac11[..., None] * _g(table, ind1 + 1))


def _major_2sp(table, ind0, ind1, fs, c, stride):
    fse = fs[..., None]

    def part(ind, fA, fB):
        return (fA[..., None] * ((1 - fse) * _g(table, ind)
                                 + fse * _g(table, ind + 1))
                + fB[..., None] * ((1 - fse) * _g(table, ind + stride)
                                   + fse * _g(table, ind + stride + 1)))
    return part(ind0, c.fac00, c.fac10) + part(ind1, c.fac01, c.fac11)


def _selffor(t, c):
    selfref, forref = t["selfref"], t["forref"]
    inds0, indf0 = c.indself - 1, c.indfor - 1
    tauself = c.selffac[..., None] * (
        _g(selfref, inds0) + c.selffrac[..., None]
        * (_g(selfref, inds0 + 1) - _g(selfref, inds0)))
    taufor = c.forfac[..., None] * (
        _g(forref, indf0) + c.forfrac[..., None]
        * (_g(forref, indf0 + 1) - _g(forref, indf0)))
    return tauself, taufor


def _gather_lay(arr, idx):
    """arr (nlay, ...), idx (...) layer indices -> (...)."""
    return take_level(arr, idx)


def _laysolfr_lower(c, layreffr, laytrop0):
    """0-based solar-source layer for lower-atmosphere bands
    (laysolfr = min(lay+1, laytrop), last matching lay; default laytrop)."""
    nlay = c.jp.shape[0]
    kk = jnp.arange(nlay, dtype=jnp.int32)[:, None]
    jp_next = jnp.concatenate([c.jp[1:], c.jp[-1:]], axis=0)
    cond = (c.jp < layreffr) & (jp_next >= layreffr) & c.tropo
    lay = jnp.max(jnp.where(cond, kk, -1), axis=0)
    return jnp.where(lay >= 0, jnp.minimum(lay + 1, laytrop0), laytrop0)


def _laysolfr_upper(c, layreffr):
    """0-based solar-source layer for upper-atmosphere bands
    (default nlayers; last lay with jp(lay-1) < layreffr <= jp(lay))."""
    nlay = c.jp.shape[0]
    kk = jnp.arange(nlay, dtype=jnp.int32)[:, None]
    jp_prev = jnp.concatenate([c.jp[:1], c.jp[:-1]], axis=0)
    cond = (jp_prev < layreffr) & (c.jp >= layreffr) & ~c.tropo
    lay = jnp.max(jnp.where(cond, kk, -1), axis=0)
    return jnp.where(lay >= 0, lay, nlay - 1)


def _sflux_eta(sfluxref, js, fs):
    """sfluxref (g, neta); js (N,) 1-based; -> (N, g)."""
    neta = sfluxref.shape[1]
    j0 = jnp.clip(js - 1, 0, neta - 2)
    lo = sfluxref.T[j0]            # (N, g)
    hi = sfluxref.T[j0 + 1]
    return lo + fs[..., None] * (hi - lo)


def taumol_sw(tables, c):
    """Gas + Rayleigh optical depth and the solar source for all 112
    g-points.  Returns (taug, taur) (nlay, N, 112) and sfluxzen (N, 112).
    """
    tropo = c.tropo[..., None]
    laytrop0 = jnp.maximum(jnp.sum(c.tropo.astype(jnp.int32), axis=0) - 1,
                           0)
    taug_parts, taur_parts, sflux_parts = [], [], []

    def tauray_scalar(t):
        return c.colmol[..., None] * t["rayl"]

    def tauray_g(t):
        return c.colmol[..., None] * t["rayl"][None, None, :]

    def sflux_const(t, scale=1.0):
        n = c.colh2o.shape[-1]
        return jnp.broadcast_to(t["sfluxref"][None] * scale,
                                (n, t["sfluxref"].shape[0]))

    def sflux_lower_eta(t, col1, col2, rat, layreffr):
        lay = _laysolfr_lower(c, layreffr, laytrop0)
        c1, c2 = _gather_lay(col1, lay), _gather_lay(col2, lay)
        _, js, fs = _spec(c1, rat, c2, 8.0)
        return _sflux_eta(t["sfluxref"], js, fs)

    def sflux_upper_eta(t, col1, col2, rat, layreffr):
        lay = _laysolfr_upper(c, layreffr)
        c1, c2 = _gather_lay(col1, lay), _gather_lay(col2, lay)
        _, js, fs = _spec(c1, rat, c2, 4.0)
        return _sflux_eta(t["sfluxref"], js, fs)

    # ---- band 16: low h2o,ch4; high ch4 -------------------------------
    t = tables[0]
    tauself, taufor = _selffor(t, c)
    _, js, fs = _spec(c.colh2o, t["strrat1"], c.colch4, 8.0)
    speccomb = c.colh2o + t["strrat1"] * c.colch4
    i0, i1 = _ind_a(c, 1, js)
    lower = speccomb[..., None] * _major_2sp(t["absa"], i0, i1, fs, c, 9) \
        + tauself + taufor
    b0, b1 = _ind_b(c, 1)
    upper = c.colch4[..., None] * _major_1sp(t["absb"], b0, b1, c)
    taug_parts.append(jnp.where(tropo, lower, upper))
    taur_parts.append(jnp.broadcast_to(tauray_scalar(t), lower.shape))
    sflux_parts.append(sflux_const(t))

    # ---- band 17: low h2o,co2; high h2o,co2 ----------------------------
    t = tables[1]
    tauself, taufor = _selffor(t, c)
    speccomb = c.colh2o + t["strrat"] * c.colco2
    _, js, fs = _spec(c.colh2o, t["strrat"], c.colco2, 8.0)
    i0, i1 = _ind_a(c, 2, js)
    lower = speccomb[..., None] * _major_2sp(t["absa"], i0, i1, fs, c, 9) \
        + tauself + taufor
    _, jsb, fsb = _spec(c.colh2o, t["strrat"], c.colco2, 4.0)
    b0, b1 = _ind_b(c, 2, jsb)
    upper = speccomb[..., None] * _major_2sp(t["absb"], b0, b1, fsb, c, 5) \
        + taufor
    taug_parts.append(jnp.where(tropo, lower, upper))
    taur_parts.append(jnp.broadcast_to(tauray_scalar(t), lower.shape))
    sflux_parts.append(sflux_upper_eta(t, c.colh2o, c.colco2, t["strrat"],
                                       t["layreffr"]))

    # ---- band 18: low h2o,ch4; high ch4 --------------------------------
    t = tables[2]
    tauself, taufor = _selffor(t, c)
    speccomb = c.colh2o + t["strrat"] * c.colch4
    _, js, fs = _spec(c.colh2o, t["strrat"], c.colch4, 8.0)
    i0, i1 = _ind_a(c, 3, js)
    lower = speccomb[..., None] * _major_2sp(t["absa"], i0, i1, fs, c, 9) \
        + tauself + taufor
    b0, b1 = _ind_b(c, 3)
    upper = c.colch4[..., None] * _major_1sp(t["absb"], b0, b1, c)
    taug_parts.append(jnp.where(tropo, lower, upper))
    taur_parts.append(jnp.broadcast_to(tauray_scalar(t), lower.shape))
    sflux_parts.append(sflux_lower_eta(t, c.colh2o, c.colch4, t["strrat"],
                                       t["layreffr"]))

    # ---- band 19: low h2o,co2; high co2 --------------------------------
    t = tables[3]
    tauself, taufor = _selffor(t, c)
    speccomb = c.colh2o + t["strrat"] * c.colco2
    _, js, fs = _spec(c.colh2o, t["strrat"], c.colco2, 8.0)
    i0, i1 = _ind_a(c, 4, js)
    lower = speccomb[..., None] * _major_2sp(t["absa"], i0, i1, fs, c, 9) \
        + tauself + taufor
    b0, b1 = _ind_b(c, 4)
    upper = c.colco2[..., None] * _major_1sp(t["absb"], b0, b1, c)
    taug_parts.append(jnp.where(tropo, lower, upper))
    taur_parts.append(jnp.broadcast_to(tauray_scalar(t), lower.shape))
    sflux_parts.append(sflux_lower_eta(t, c.colh2o, c.colco2, t["strrat"],
                                       t["layreffr"]))

    # ---- band 20: low h2o (+ch4 minor); high h2o -----------------------
    t = tables[4]
    tauself, taufor = _selffor(t, c)
    i0, i1 = _ind_a(c, 5)
    lower = c.colh2o[..., None] * _major_1sp(t["absa"], i0, i1, c) \
        + tauself + taufor + c.colch4[..., None] * t["absch4"][None, None]
    b0, b1 = _ind_b(c, 5)
    upper = c.colh2o[..., None] * _major_1sp(t["absb"], b0, b1, c) \
        + taufor + c.colch4[..., None] * t["absch4"][None, None]
    taug_parts.append(jnp.where(tropo, lower, upper))
    taur_parts.append(jnp.broadcast_to(tauray_scalar(t), lower.shape))
    sflux_parts.append(sflux_const(t))

    # ---- band 21: low h2o,co2; high h2o,co2 ----------------------------
    t = tables[5]
    tauself, taufor = _selffor(t, c)
    speccomb = c.colh2o + t["strrat"] * c.colco2
    _, js, fs = _spec(c.colh2o, t["strrat"], c.colco2, 8.0)
    i0, i1 = _ind_a(c, 6, js)
    lower = speccomb[..., None] * _major_2sp(t["absa"], i0, i1, fs, c, 9) \
        + tauself + taufor
    _, jsb, fsb = _spec(c.colh2o, t["strrat"], c.colco2, 4.0)
    b0, b1 = _ind_b(c, 6, jsb)
    upper = speccomb[..., None] * _major_2sp(t["absb"], b0, b1, fsb, c, 5) \
        + taufor
    taug_parts.append(jnp.where(tropo, lower, upper))
    taur_parts.append(jnp.broadcast_to(tauray_scalar(t), lower.shape))
    sflux_parts.append(sflux_lower_eta(t, c.colh2o, c.colco2, t["strrat"],
                                       t["layreffr"]))

    # ---- band 22: low h2o,o2; high o2 ----------------------------------
    t = tables[6]
    o2adj = 1.6
    tauself, taufor = _selffor(t, c)
    o2cont = (4.35e-4 * c.colo2 / 700.0)[..., None]
    rat22 = o2adj * t["strrat"]
    speccomb = c.colh2o + rat22 * c.colo2
    _, js, fs = _spec(c.colh2o, rat22, c.colo2, 8.0)
    i0, i1 = _ind_a(c, 7, js)
    lower = speccomb[..., None] * _major_2sp(t["absa"], i0, i1, fs, c, 9) \
        + tauself + taufor + o2cont
    b0, b1 = _ind_b(c, 7)
    upper = (c.colo2 * o2adj)[..., None] * _major_1sp(t["absb"], b0, b1, c) \
        + o2cont
    taug_parts.append(jnp.where(tropo, lower, upper))
    taur_parts.append(jnp.broadcast_to(tauray_scalar(t), lower.shape))
    sflux_parts.append(sflux_lower_eta(t, c.colh2o, c.colo2, rat22,
                                       t["layreffr"]))

    # ---- band 23: low h2o; high nothing --------------------------------
    t = tables[7]
    tauself, taufor = _selffor(t, c)
    i0, i1 = _ind_a(c, 8)
    lower = c.colh2o[..., None] * (
        t["givfac"] * _major_1sp(t["absa"], i0, i1, c)) + tauself + taufor
    taug_parts.append(jnp.where(tropo, lower, 0.0))
    taur_parts.append(jnp.broadcast_to(tauray_g(t), lower.shape))
    sflux_parts.append(sflux_const(t))

    # ---- band 24: low h2o,o2 (+o3); high o2 (+o3) ----------------------
    t = tables[8]
    tauself, taufor = _selffor(t, c)
    speccomb = c.colh2o + t["strrat"] * c.colo2
    _, js, fs = _spec(c.colh2o, t["strrat"], c.colo2, 8.0)
    i0, i1 = _ind_a(c, 9, js)
    lower = speccomb[..., None] * _major_2sp(t["absa"], i0, i1, fs, c, 9) \
        + c.colo3[..., None] * t["abso3a"][None, None] + tauself + taufor
    b0, b1 = _ind_b(c, 9)
    upper = c.colo2[..., None] * _major_1sp(t["absb"], b0, b1, c) \
        + c.colo3[..., None] * t["abso3b"][None, None]
    taug_parts.append(jnp.where(tropo, lower, upper))
    # Rayleigh: eta-interpolated below laytrop (rayla (g, 9))
    rayla = t["rayla"]              # (g, 9)
    j0 = jnp.clip(js - 1, 0, rayla.shape[1] - 2)
    ray_lo = rayla.T[j0] + fs[..., None] * (rayla.T[j0 + 1] - rayla.T[j0])
    taur = jnp.where(tropo, c.colmol[..., None] * ray_lo,
                     c.colmol[..., None] * t["raylb"][None, None])
    taur_parts.append(taur)
    sflux_parts.append(sflux_lower_eta(t, c.colh2o, c.colo2, t["strrat"],
                                       t["layreffr"]))

    # ---- band 25: low h2o (+o3); high o3 -------------------------------
    t = tables[9]
    i0, i1 = _ind_a(c, 10)
    lower = c.colh2o[..., None] * _major_1sp(t["absa"], i0, i1, c) \
        + c.colo3[..., None] * t["abso3a"][None, None]
    upper = c.colo3[..., None] * t["abso3b"][None, None]
    taug_parts.append(jnp.where(tropo, lower, upper))
    taur_parts.append(jnp.broadcast_to(tauray_g(t), lower.shape))
    sflux_parts.append(sflux_const(t))

    # ---- band 26: pure Rayleigh ----------------------------------------
    t = tables[10]
    zero = jnp.zeros_like(c.colh2o[..., None] * jnp.zeros(NGC[10]))
    taug_parts.append(zero)
    taur_parts.append(jnp.broadcast_to(tauray_g(t), zero.shape))
    sflux_parts.append(sflux_const(t))

    # ---- band 27: o3 ----------------------------------------------------
    t = tables[11]
    i0, i1 = _ind_a(c, 12)
    lower = c.colo3[..., None] * _major_1sp(t["absa"], i0, i1, c)
    b0, b1 = _ind_b(c, 12)
    upper = c.colo3[..., None] * _major_1sp(t["absb"], b0, b1, c)
    taug_parts.append(jnp.where(tropo, lower, upper))
    taur_parts.append(jnp.broadcast_to(tauray_g(t), lower.shape))
    sflux_parts.append(sflux_const(t, scale=t["scalekur"]))

    # ---- band 28: o3,o2 -------------------------------------------------
    t = tables[12]
    speccomb = c.colo3 + t["strrat"] * c.colo2
    _, js, fs = _spec(c.colo3, t["strrat"], c.colo2, 8.0)
    i0, i1 = _ind_a(c, 13, js)
    lower = speccomb[..., None] * _major_2sp(t["absa"], i0, i1, fs, c, 9)
    _, jsb, fsb = _spec(c.colo3, t["strrat"], c.colo2, 4.0)
    b0, b1 = _ind_b(c, 13, jsb)
    upper = speccomb[..., None] * _major_2sp(t["absb"], b0, b1, fsb, c, 5)
    taug_parts.append(jnp.where(tropo, lower, upper))
    taur_parts.append(jnp.broadcast_to(tauray_scalar(t), lower.shape))
    sflux_parts.append(sflux_upper_eta(t, c.colo3, c.colo2, t["strrat"],
                                       t["layreffr"]))

    # ---- band 29: low h2o (+co2); high co2 (+h2o) -----------------------
    t = tables[13]
    tauself, taufor = _selffor(t, c)
    i0, i1 = _ind_a(c, 14)
    lower = c.colh2o[..., None] * _major_1sp(t["absa"], i0, i1, c) \
        + tauself + taufor + c.colco2[..., None] * t["absco2"][None, None]
    b0, b1 = _ind_b(c, 14)
    upper = c.colco2[..., None] * _major_1sp(t["absb"], b0, b1, c) \
        + c.colh2o[..., None] * t["absh2o"][None, None]
    taug_parts.append(jnp.where(tropo, lower, upper))
    taur_parts.append(jnp.broadcast_to(tauray_scalar(t), lower.shape))
    sflux_parts.append(sflux_const(t))

    # Linear (jt/fac) temperature extrapolation outside the k-table range
    # can produce negative gas optical depths (e.g. the wrapper's thick
    # extra TOA layer, whose T sits far off the reference profile at its
    # mid pressure).  The reference does not guard this — negative tau
    # makes omega = taur/tau blow up and the two-stream adding diverges —
    # so clamp to the physical bound.  Deliberate robustness divergence.
    taug = jnp.maximum(jnp.concatenate(taug_parts, axis=-1), 0.0)
    taur = jnp.concatenate(taur_parts, axis=-1)
    sfluxzen = jnp.concatenate(sflux_parts, axis=-1)
    return taug, taur, sfluxzen


# ==========================================================================
# McICA subcolumns (mcica_subcol_sw, ra_rrtmg_sw.f90:1393-1917)
# ==========================================================================

def mcica_subcol_sw(key, cldfrac, ciwp, clwp, cswp, icld=1):
    """Stochastic subcolumn generator for the 112 SW g-points;
    jax PRNG replaces the KISS generator (statistically equivalent)."""
    nlay, N = cldfrac.shape
    cdf = jax.random.uniform(key, (nlay, N, NGPTSW), jnp.float32)
    if icld >= 2:
        def body(carry, x):
            cdf_above = carry
            cdf_lay, cf_above = x
            new = jnp.where(cdf_above > 1.0 - cf_above[..., None],
                            cdf_above, cdf_lay)
            return new, new
        cf_rev = cldfrac[::-1]
        _, out = jax.lax.scan(body, cdf[::-1][0],
                              (cdf[::-1], jnp.roll(cf_rev, 1, axis=0)))
        cdf = out[::-1]
    cldy = cdf > (1.0 - cldfrac[..., None])
    return (cldy.astype(jnp.float32),
            jnp.where(cldy, ciwp[..., None], 0.0),
            jnp.where(cldy, clwp[..., None], 0.0),
            jnp.where(cldy, cswp[..., None], 0.0))


# ==========================================================================
# cloud optics (cldprmc_sw, ra_rrtmg_sw.f90:1990-2422)
# ==========================================================================

def cldprmc_sw(cldfmc, ciwpmc, clwpmc, cswpmc, rei, rel, res):
    """In-cloud SW optical properties per g-point, delta-scaled as in the
    iceflag=5 / liqflag=1 path (ICAR: has_reqc=has_reqi=has_reqs=1).
    Returns (taucmc, ssacmc, asmcmc, taormc) with shape (nlay, N, ngpt).
    Radii are clipped into table range instead of `error stop`."""
    cwp = ciwpmc + clwpmc + cswpmc
    cloudy = (cldfmc >= CLDMIN) & (cwp >= CLDMIN)

    def ice_props(rad):
        # Fortran: index = int((rad-2)/3) in 1..46, capped at 45 (:2166)
        factor = (jnp.clip(rad, 5.0, 140.0) - 2.0) / 3.0
        idx = jnp.minimum(jnp.floor(factor).astype(jnp.int32), 45)
        fint = factor - idx.astype(jnp.float32)
        idx0 = idx - 1

        # gather band column per g-point: tables are (46, 14)
        def interp_g(tab):
            lo = tab[jnp.clip(idx0, 0, 45)]          # (..., 14)
            hi = tab[jnp.clip(idx0 + 1, 0, 45)]
            v = lo + fint[..., None] * (hi - lo)     # (..., 14)
            return v[..., NGB0]                      # (..., ngpt)
        ext = interp_g(EXTICE3)
        ssa = interp_g(SSAICE3)
        asy = interp_g(ASYICE3)
        fdelta = jnp.clip(interp_g(FDLICE3), 0.0, 1.0)
        forw = jnp.minimum(fdelta + 0.5 / jnp.maximum(ssa, 1e-12), asy)
        return ext, ssa, asy, forw

    exti, ssai, asyi, forwi = ice_props(rei)
    exts, ssas, asys, forws = ice_props(res)

    # liquid (Hu & Stamnes, liqflag=1; extliq1 (58, 14))
    radliq = jnp.clip(rel, 1.5, 60.0)
    idxl = jnp.clip(jnp.floor(radliq - 1.5).astype(jnp.int32), 1, 57)
    fintl = radliq - 1.5 - idxl.astype(jnp.float32)
    idxl0 = idxl - 1

    def interp_liq(tab):
        lo = tab[idxl0]
        hi = tab[jnp.clip(idxl0 + 1, 0, 57)]
        v = lo + fintl[..., None] * (hi - lo)
        return v[..., NGB0]
    extl = interp_liq(EXTLIQ1)
    ssal = jnp.minimum(interp_liq(SSALIQ1), 1.0)
    asyl = interp_liq(ASYLIQ1)
    forwl = asyl * asyl

    # per-g zeroing when a species is absent (:2106-2117, :2303-2309)
    icemask = (ciwpmc + cswpmc) > 0.0
    exti = jnp.where(icemask, exti, 0.0)
    ssai = jnp.where(icemask, ssai, 0.0)
    asyi = jnp.where(icemask, asyi, 0.0)
    forwi = jnp.where(icemask, forwi, 0.0)
    snomask = cswpmc > 0.0
    exts = jnp.where(snomask, exts, 0.0)
    ssas = jnp.where(snomask, ssas, 0.0)
    asys = jnp.where(snomask, asys, 0.0)
    forws = jnp.where(snomask, forws, 0.0)
    liqmask = clwpmc > 0.0
    extl = jnp.where(liqmask, extl, 0.0)
    ssal = jnp.where(liqmask, ssal, 0.0)
    asyl = jnp.where(liqmask, asyl, 0.0)
    forwl = jnp.where(liqmask, forwl, 0.0)

    # combine + delta scaling by forward fraction (:2337-2410, iceflag=5)
    tauliqorig = clwpmc * extl
    tauiceorig = ciwpmc * exti
    tausnoorig = cswpmc * exts
    taormc = tauliqorig + tauiceorig + tausnoorig

    def dscale(ssa0, forw, tau0):
        denom = jnp.maximum(1.0 - forw * ssa0, 1e-12)
        return ssa0 * (1.0 - forw) / denom, (1.0 - forw * ssa0) * tau0
    ssaliq, tauliq = dscale(ssal, forwl, tauliqorig)
    ssaice, tauice = dscale(ssai, forwi, tauiceorig)
    ssasno, tausno = dscale(ssas, forws, tausnoorig)
    scatliq = ssaliq * tauliq
    scatice = ssaice * tauice
    scatsno = ssasno * tausno
    taucmc = tauliq + tauice + tausno
    taucmc = jnp.where(taucmc == 0.0, CLDMIN, taucmc)
    scatice = jnp.where(scatice == 0.0, CLDMIN, scatice)
    scatsno = jnp.where(scatsno == 0.0, CLDMIN, scatsno)
    ssacmc = (scatliq + scatice + scatsno) / taucmc
    asmcmc = (scatliq * (asyl - forwl) / jnp.maximum(1.0 - forwl, 1e-12)
              + scatice * (asyi - forwi) / jnp.maximum(1.0 - forwi, 1e-12)
              + scatsno * (asys - forws) / jnp.maximum(1.0 - forws, 1e-12)
              ) / (scatliq + scatice + scatsno)

    z = jnp.zeros_like(taucmc)
    return (jnp.where(cloudy, taucmc, z), jnp.where(cloudy, ssacmc, z),
            jnp.where(cloudy, asmcmc, z), jnp.where(cloudy, taormc, z))


# ==========================================================================
# two-stream reflectance/transmittance (reftra_sw, :2454-2734)
# ==========================================================================

def reftra_sw(pgg, prmuz, ptau, pw, active):
    """PIFM (kmodts=2) two-stream layer reflectance/transmittance for
    direct and diffuse incidence.  All inputs broadcastable (nlay, N, ng);
    prmuz (N,) or scalar.  `active` masks layers that need the calc
    (clear: all; cloudy: cloudy layers only — inactive gives r=0, t=1)."""
    eps = 1e-8
    w = pw
    g = pgg
    mu = prmuz                       # already broadcast by the caller

    gamma1 = (8.0 - w * (5.0 + 3.0 * g)) * 0.25
    gamma2 = 3.0 * (w * (1.0 - g)) * 0.25
    gamma3 = (2.0 - 3.0 * g * mu) * 0.25
    gamma4 = 1.0 - gamma3

    # conservative-scattering test on the un-delta-scaled ssa (:2597)
    denom_w = 1.0 - (1.0 - w) * jnp.where(
        g == 1.0, 0.0, (g / jnp.maximum(1.0 - g, 1e-12)) ** 2)
    zwo = jnp.where((w > 0.0) & (denom_w != 0.0), w / jnp.where(
        denom_w == 0.0, 1.0, denom_w), 0.0)
    conserv = zwo >= 0.9999995

    ze2_dir = jnp.exp(-jnp.minimum(ptau / mu, 500.0))

    # conservative branch (:2608-2640)
    za = gamma1 * mu
    za1 = za - gamma3
    zgt = gamma1 * ptau
    ref_c = (zgt - za1 * (1.0 - ze2_dir)) / (1.0 + zgt)
    tra_c = 1.0 - ref_c
    refd_c = zgt / (1.0 + zgt)
    trad_c = 1.0 - refd_c

    # non-conservative branch (:2644-2732)
    za1n = gamma1 * gamma4 + gamma2 * gamma3
    za2n = gamma1 * gamma3 + gamma2 * gamma4
    zrk = jnp.sqrt(jnp.maximum(gamma1 * gamma1 - gamma2 * gamma2, 1e-12))
    zrp = zrk * mu
    zrp1, zrm1 = 1.0 + zrp, 1.0 - zrp
    zrk2 = 2.0 * zrk
    zrpp = 1.0 - zrp * zrp
    zrkg = zrk + gamma1
    zr1 = zrm1 * (za2n + zrk * gamma3)
    zr2 = zrp1 * (za2n - zrk * gamma3)
    zr3 = zrk2 * (gamma3 - za2n * mu)
    zr4 = zrpp * zrkg
    zr5 = zrpp * (zrk - gamma1)
    zt1 = zrp1 * (za1n + zrk * gamma4)
    zt2 = zrm1 * (za1n - zrk * gamma4)
    zt3 = zrk2 * (gamma4 + za1n * mu)
    zbeta = (gamma1 - zrk) / zrkg

    # the reference caps the exponent at 500 in float64; in float32 the
    # exp AND its products with the zr/zt coefficients must stay finite,
    # so cap at 40 (transmittance ~1e-18 there — zero either way)
    ze1 = jnp.minimum(zrk * ptau, 40.0)
    ze2 = jnp.minimum(ptau / mu, 40.0)
    zem1 = jnp.exp(-ze1)
    zep1 = jnp.exp(ze1)
    zem2 = jnp.exp(-ze2)
    zep2 = jnp.exp(ze2)

    zdenr = zr4 * zep1 + zr5 * zem1
    zdent = zr4 * zep1 + zr5 * zem1
    small = jnp.abs(zdenr) <= eps
    ref_n = jnp.where(small, eps,
                      w * (zr1 * zep1 - zr2 * zem1 - zr3 * zem2)
                      / jnp.where(small, 1.0, zdenr))
    tra_n = jnp.where(
        small, zem2,
        zem2 - zem2 * w * (zt1 * zep1 - zt2 * zem1 - zt3 * zep2)
        / jnp.where(small, 1.0, zdent))
    zemm = zem1 * zem1
    zdend = 1.0 / jnp.maximum((1.0 - zbeta * zemm) * zrkg, 1e-12)
    refd_n = gamma2 * (1.0 - zemm) * zdend
    trad_n = zrk2 * zem1 * zdend

    pref = jnp.where(conserv, ref_c, ref_n)
    ptra = jnp.where(conserv, tra_c, tra_n)
    prefd = jnp.where(conserv, refd_c, refd_n)
    ptrad = jnp.where(conserv, trad_c, trad_n)
    # float32 guard: near-conservative thick layers can round prefd to
    # exactly 1, which blows up the 1/(1 - r*r') adding denominators
    # (the reference runs in float64 where this cannot happen)
    prefd = jnp.clip(prefd, 0.0, 1.0 - 1e-6)
    z, one = jnp.zeros_like(pref), jnp.ones_like(pref)
    return (jnp.where(active, pref, z), jnp.where(active, prefd, z),
            jnp.where(active, ptra, one), jnp.where(active, ptrad, one))


# ==========================================================================
# vertical adding (vrtqdr_sw, :7956-8080)
# ==========================================================================

def vrtqdr_sw(pref, prefd, ptra, ptrad, pdbt, ptdbt, palbp, palbd):
    """Vertical quadrature.  Layer arrays (nlay, ..., ng) are ordered TOP
    to BOTTOM (jk=1 = top) as in the Fortran; level arrays (nlay+1, ...)
    with index 0 = TOA.  Returns (pfd, pfu) at levels (TOA..surface)."""
    nlay = pref.shape[0]
    # surface rows (jk = klev+1)
    ref_s = jnp.broadcast_to(palbp, pref.shape[1:])
    refd_s = jnp.broadcast_to(palbd, pref.shape[1:])

    # bottom-up pass: prup/prupd
    def up_body(carry, x):
        rup_below, rupd_below = carry
        ref_k, refd_k, tra_k, trad_k, dbt_k = x
        zreflect = 1.0 / jnp.maximum(1.0 - rupd_below * refd_k, 1e-6)
        rup = ref_k + (trad_k * ((tra_k - dbt_k) * rupd_below
                                 + dbt_k * rup_below)) * zreflect
        rupd = refd_k + trad_k * trad_k * rupd_below * zreflect
        return (rup, rupd), (rup, rupd)

    layers_rev = (pref[::-1], prefd[::-1], ptra[::-1], ptrad[::-1],
                  pdbt[:nlay][::-1])
    (_, _), (rup_rev, rupd_rev) = jax.lax.scan(up_body, (ref_s, refd_s),
                                               layers_rev)
    prup = jnp.concatenate([rup_rev[::-1], ref_s[None]], axis=0)
    prupd = jnp.concatenate([rupd_rev[::-1], refd_s[None]], axis=0)

    # top-down pass: ztdn / prdnd
    def dn_body(carry, x):
        tdn_k, rdnd_k = carry
        ref_k, refd_k, tra_k, trad_k, tdbt_k = x
        zreflect = 1.0 / jnp.maximum(1.0 - refd_k * rdnd_k, 1e-6)
        tdn_kp = tdbt_k * tra_k + (trad_k * ((tdn_k - tdbt_k)
                                             + tdbt_k * ref_k * rdnd_k)) \
            * zreflect
        rdnd_kp = refd_k + trad_k * trad_k * rdnd_k * zreflect
        return (tdn_kp, rdnd_kp), (tdn_k, rdnd_k)

    one = jnp.ones_like(ref_s)
    zero = jnp.zeros_like(ref_s)
    (tdn_last, rdnd_last), (tdn_hist, rdnd_hist) = jax.lax.scan(
        dn_body, (one, zero),
        (pref, prefd, ptra, ptrad, ptdbt[:nlay]))
    ztdn = jnp.concatenate([tdn_hist, tdn_last[None]], axis=0)
    prdnd = jnp.concatenate([rdnd_hist, rdnd_last[None]], axis=0)

    zreflect = 1.0 / jnp.maximum(1.0 - prdnd * prupd, 1e-6)
    pfu = (ptdbt * prup + (ztdn - ptdbt) * prupd) * zreflect
    pfd = ptdbt + (ztdn - ptdbt + ptdbt * prup * prdnd) * zreflect
    return pfd, pfu


# ==========================================================================
# spectral solver (spcvmc_sw, :8117-8684)
# ==========================================================================

def spcvmc_sw(taug, taur, sfluxzen, cldfmc, taucmc, ssacmc, asmcmc,
              taormc, albdir, albdif, prmu0, adjflux):
    """Two-stream fluxes for every g-point at once.

    taug/taur/cloud arrays: (nlay, N, ng) BOTTOM to TOP; albdir/albdif
    (N,); prmu0 (N,); adjflux scalar.  Returns (nlay+1, N) total-sky and
    clear-sky down/up fluxes plus the direct down flux, all bottom-to-top
    (index 0 = surface)."""
    nlay = taug.shape[0]
    mu = prmu0[None, :, None]          # broadcast vs (nlay, N, ng)

    # flip to top-to-bottom like the Fortran two-stream section
    flip = lambda a: a[::-1]
    taug_t, taur_t = flip(taug), flip(taur)
    cldf_t = flip(cldfmc)
    tauc_t, ssac_t = flip(taucmc), flip(ssacmc)
    asmc_t, taor_t = flip(asmcmc), flip(taormc)

    # clear-sky optical parameters (aerosol-free: ICAR passes tauaer=0)
    ztauc = taur_t + taug_t
    zomcc = taur_t / jnp.maximum(ztauc, 1e-20)
    zgcc = jnp.zeros_like(ztauc)

    # direct transmittance with UNSCALED cloud optical depth (:8490-8524)
    zdbtc_nodel = jnp.exp(-jnp.minimum(ztauc / mu, 500.0))
    zdbt_nodel = (1.0 - cldf_t) * zdbtc_nodel + cldf_t * jnp.exp(
        -jnp.minimum((ztauc + taor_t) / mu, 500.0))
    cumprod_lvl = lambda a: jnp.concatenate(
        [jnp.ones_like(a[:1]), jnp.cumprod(a, axis=0)], axis=0)
    ztdbtc_nodel = cumprod_lvl(zdbtc_nodel)
    ztdbt_nodel = cumprod_lvl(zdbt_nodel)

    # delta-scale clear sky (zf = g^2 = 0 -> no-op, kept for parity)
    zf = zgcc * zgcc
    zwf = zomcc * zf
    ztauc = (1.0 - zwf) * ztauc
    zomcc = (zomcc - zwf) / jnp.maximum(1.0 - zwf, 1e-12)
    zgcc = (zgcc - zf) / jnp.maximum(1.0 - zf, 1e-12)

    # total-sky optical parameters (icpr=1: cloud already delta-scaled)
    ztauo = ztauc + tauc_t
    zomco_n = ztauc * zomcc + tauc_t * ssac_t
    zgco = (tauc_t * ssac_t * asmc_t + ztauc * zomcc * zgcc) \
        / jnp.maximum(zomco_n, 1e-20)
    zomco = zomco_n / jnp.maximum(ztauo, 1e-20)

    # layer reflectance/transmittance
    active_cld = cldf_t > REPCLC
    refc, refdc, trac, tradc = reftra_sw(zgcc, mu, ztauc, zomcc, True)
    refo, refdo, trao, trado = reftra_sw(zgco, mu, ztauo, zomco,
                                         active_cld)
    zclear = 1.0 - cldf_t
    zref = zclear * refc + cldf_t * refo
    zrefd = zclear * refdc + cldf_t * refdo
    ztra = zclear * trac + cldf_t * trao
    ztrad = zclear * tradc + cldf_t * trado

    # direct beam with delta-scaled optical depths (:8585-8620)
    zdbtc = jnp.exp(-jnp.minimum(ztauc / mu, 500.0))
    zdbt = zclear * zdbtc + cldf_t * jnp.exp(
        -jnp.minimum(ztauo / mu, 500.0))
    ztdbtc = cumprod_lvl(zdbtc)
    ztdbt = cumprod_lvl(zdbt)

    albp = albdir[..., None]
    albd = albdif[..., None]
    fd_c, fu_c = vrtqdr_sw(refc, refdc, trac, tradc,
                           jnp.concatenate([zdbtc,
                                            jnp.zeros_like(zdbtc[:1])], 0),
                           ztdbtc, albp, albd)
    fd, fu = vrtqdr_sw(zref, zrefd, ztra, ztrad,
                       jnp.concatenate([zdbt,
                                        jnp.zeros_like(zdbt[:1])], 0),
                       ztdbt, albp, albd)

    # incident flux and spectral sum; flip levels back to bottom-to-top
    zincflx = adjflux * sfluxzen * prmu0[..., None]      # (N, ng)
    tot = lambda f: jnp.sum(zincflx[None] * f, axis=-1)[::-1]
    swdflx = tot(fd)
    swuflx = tot(fu)
    swdflxc = tot(fd_c)
    swuflxc = tot(fu_c)
    swddir = tot(ztdbt_nodel)
    swddirc = tot(ztdbtc_nodel)
    return swdflx, swuflx, swdflxc, swuflxc, swddir, swddirc


# ==========================================================================
# top-level column model (rrtmg_sw, :8766-9521)
# ==========================================================================

def rrtmg_sw_rad(tables, play, plev, tlay, cosz, albedo, h2ovmr, o3vmr,
                 cldfrac, ciwp, clwp, cswp, rei, rel, res, key, scon,
                 icld=1, co2vmr=CO2VMR, n2ovmr=N2OVMR, ch4vmr=CH4VMR):
    """Full SW calculation on (nlay, N) columns, bottom-to-top.

    Returns a namespace with swdflx/swuflx/swdflxc/swuflxc (nlay+1, N)
    (index 0 = surface), heating rate swhr (nlay, N) [K/day], and the
    direct downward surface flux."""
    tables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a,
        tables)
    nlay, N = play.shape
    dpg = plev[:-1] - plev[1:]
    coldry = dpg * 1e3 * AVOGAD / (1e2 * GRAV * AMD
                                   * (1.0 + h2ovmr * AMW / AMD))
    wkl = jnp.stack([h2ovmr * coldry, co2vmr * coldry, o3vmr * coldry,
                     n2ovmr * coldry, jnp.zeros_like(coldry),
                     ch4vmr * coldry, O2VMR * coldry])
    c = setcoef_sw(play, tlay, coldry, wkl)
    taug, taur, sfluxzen = taumol_sw(tables, c)

    cldfmc, ciwpmc, clwpmc, cswpmc = mcica_subcol_sw(
        key, cldfrac, ciwp, clwp, cswp, icld=icld)
    taucmc, ssacmc, asmcmc, taormc = cldprmc_sw(
        cldfmc, ciwpmc, clwpmc, cswpmc, rei, rel, res)

    mu0 = jnp.maximum(cosz, ZEPZEN)
    adjflux = scon / RRSW_SCON          # adjes=1, dyofyr=0 (wrapper)
    swdflx, swuflx, swdflxc, swuflxc, swddir, swddirc = spcvmc_sw(
        taug, taur, sfluxzen, cldfmc, taucmc, ssacmc, asmcmc, taormc,
        albedo, albedo, mu0, adjflux)

    fnet = swdflx - swuflx
    fnetc = swdflxc - swuflxc
    swhr = HEATFAC * (fnet[1:] - fnet[:-1]) / dpg
    swhrc = HEATFAC * (fnetc[1:] - fnetc[:-1]) / dpg
    # top layer heating zeroed (:9464-9465)
    swhr = swhr.at[-1].set(0.0)
    swhrc = swhrc.at[-1].set(0.0)
    return SimpleNamespace(swdflx=swdflx, swuflx=swuflx, swdflxc=swdflxc,
                           swuflxc=swuflxc, swhr=swhr, swhrc=swhrc,
                           swddir=swddir)


# ==========================================================================
# ICAR-facing driver (RRTMG_SWRAD, ra_rrtmg_sw.f90:9933-11303)
# ==========================================================================

def rrtmg_sw_driver(tables, key, p3d, p8w, t3d, t8w, cosz2d, albedo2d,
                    qv3d, qc3d, qi3d, qs3d, cldfra3d, re_cloud, re_ice,
                    re_snow, rho3d, dz8w, exner, xland=None,
                    solar_constant=1366.0, mp_option=0, ghg=None):
    """(z, y, x) fields -> columns -> rrtmg_sw_rad -> theta tendency.

    Adds the single extra layer from model top to TOA (plev = 1e-5 hPa)
    exactly as the wrapper does (:10700-10760).  Night columns
    (cosz <= 0) are masked to zero afterwards (the wrapper skips them,
    :10381).  Returns (th_tend [K/s on theta], swdown, gsw, swcf)."""
    nz, ny, nx = p3d.shape
    N = ny * nx
    flat = lambda a: a.reshape(a.shape[0], N)
    play = flat(p3d) / 100.0
    ptop_if = jnp.maximum(2.0 * p3d[-1] - p8w[-1], p8w[-1] * 0.5) / 100.0
    plev = jnp.concatenate([flat(p8w) / 100.0, ptop_if.reshape(1, N)],
                           axis=0)
    tlay = flat(t3d)
    ttop_if = 2.0 * t3d[-1] - t8w[-1]
    # extra layer to TOA (:10700-10707)
    play = jnp.concatenate([play, 0.5 * plev[-1:]], axis=0)
    plev = jnp.concatenate([plev, jnp.full((1, N), 1.0e-5)], axis=0)
    tlay = jnp.concatenate([tlay, ttop_if.reshape(1, N)], axis=0)

    ext = lambda a: jnp.concatenate([flat(a), flat(a)[-1:]], axis=0)
    h2ovmr = ext(qv3d) * (AMD / AMW)
    o3vmr = _o3_profile(play) * (AMD / 47.9982)

    cf = jnp.clip(flat(cldfra3d), 0.0, 1.0)
    gwp = lambda q: jnp.where(
        cf > 0.0, 1000.0 * flat(q * rho3d * dz8w) / jnp.maximum(cf, 1e-3),
        0.0)
    zrow = jnp.zeros((1, N))
    pad = lambda a: jnp.concatenate([a, zrow], axis=0)
    clwp = pad(gwp(qc3d))
    ciwp = pad(gwp(qi3d))
    cswp = pad(gwp(qs3d))
    cf = pad(cf)

    # NOTE reference quirk preserved: with mp_options /= 5 the wrapper
    # FORCES re_cloud=10.5, re_ice=30, re_snow=500 um (:10578-10650); ICAR
    # hardcodes mp_options=0 (ra_driver.f90:246).  re_snow=500 would
    # `error stop` in cldprmc_sw — we clip to the 140 um table edge.
    if mp_option != 5:
        rel = jnp.full_like(cf, 10.5)
        rei = jnp.full_like(cf, 30.0)
        res = jnp.full_like(cf, 140.0)
    else:
        rel = jnp.maximum(2.5, pad(flat(re_cloud)) * 1e6)
        rel_fb = 10.5 if xland is None else jnp.where(
            xland.reshape(N)[None] > 1.5, 10.5, 7.5)
        rel = jnp.where((rel <= 2.5) & (cf > 0.0), rel_fb, rel)
        rei = jnp.maximum(5.0, pad(flat(re_ice)) * 1e6)
        res = jnp.clip(jnp.maximum(10.0, pad(flat(re_snow)) * 1e6),
                       5.0, 140.0)

    cosz = cosz2d.reshape(N)
    gkw = {} if ghg is None else dict(co2vmr=ghg.co2, n2ovmr=ghg.n2o,
                                      ch4vmr=ghg.ch4)
    from .rrtmg_lw import RRTMG_COL_CHUNK, column_chunked

    def _rad_chunk(k, play_c, plev_c, tlay_c, cosz_c, alb_c, h2o, o3,
                   cfc, ciw, clw, csw, rei_c, rel_c, res_c):
        o = rrtmg_sw_rad(tables, play_c, plev_c, tlay_c, cosz_c, alb_c,
                         h2o, o3, cfc, ciw, clw, csw, rei_c, rel_c,
                         res_c, k, scon=solar_constant, **gkw)
        return dict(swhr=o.swhr[:nz], swd0=o.swdflx[0],
                    swu0=o.swuflx[0], swdT=o.swdflx[-1],
                    swuT=o.swuflx[-1], swdcT=o.swdflxc[-1],
                    swucT=o.swuflxc[-1], swddir0=o.swddir[0])

    out = column_chunked(
        _rad_chunk, key,
        (play, plev, tlay, cosz, albedo2d.reshape(N), h2ovmr, o3vmr,
         cf, ciwp, clwp, cswp, rei, rel, res), N, RRTMG_COL_CHUNK)

    day2 = cosz > 0.0
    day = day2[None]
    swhr = jnp.where(day, out["swhr"], 0.0)
    swd0 = jnp.where(day2, out["swd0"], 0.0)
    swu0 = jnp.where(day2, out["swu0"], 0.0)
    swddir = jnp.where(day2, out["swddir0"], 0.0)[None]

    swdown = swd0.reshape(ny, nx)
    gsw = (swd0 - swu0).reshape(ny, nx)
    swcf = jnp.where(
        day2, (out["swdT"] - out["swuT"])
        - (out["swdcT"] - out["swucT"]), 0.0).reshape(ny, nx)
    # direct-beam surface flux (SWDDIR, ra_rrtmg_sw.f90 wrapper outputs;
    # the diffuse component is swdown - swdir, VERDICT r3 item #8).
    # Clamped to swdown: the unscaled-tau direct transmittance can
    # slightly exceed the delta-scaled total under thick cloud.
    swdir = jnp.minimum(swddir[0].reshape(ny, nx), swdown)
    th_tend = (swhr / 86400.0).reshape(nz, ny, nx) / exner
    return th_tend, swdown, gsw, swcf, swdir


# --------------------------------------------------------------------------
# table resolution for model runs
# --------------------------------------------------------------------------

_TABLES = None


def set_sw_tables(tables):
    global _TABLES
    _TABLES = tables


def get_sw_tables(support_dir="rrtmg_support"):
    global _TABLES
    if _TABLES is None:
        from .rrtmg_sw_tables import load_sw_tables
        try:
            _TABLES = load_sw_tables(support_dir)
        except (FileNotFoundError, OSError) as e:
            raise FileNotFoundError(
                f"RRTMG-SW k-distribution data not found in "
                f"'{support_dir}'. rad=3 with use_simple_sw=false needs "
                "the external rrtmg_support files. Tests can inject "
                "synthetic tables via icar_tpu.physics.rrtmg_sw."
                "set_sw_tables(rrtmg_sw_tables.synthetic_sw_tables())."
            ) from e
    return _TABLES
