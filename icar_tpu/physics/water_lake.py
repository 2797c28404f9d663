"""CLM4.5 shallow-lake model (water=3), a JAX rewrite.

Re-implementation of /root/reference/src/physics/water_lake.f90 (the WRF/CLM
lake scheme of Subin et al. 2012 / Gu et al. 2013 as adapted for ICAR):
a one-dimensional mass-and-energy-balance column with 10 lake layers, up to
5 snow layers and 4 soil layers beneath the lake bed.

Architecture: the reference iterates one scalar column at a time inside an
(i, j) loop (water_lake.f90:269-439).  Here every routine is written as
masked array math over the full (y, x) grid with a fixed layer axis; the
dynamic snow-layer stack (snl in [-5, 0]) becomes where-masks over
fixed-size arrays, and the sequential layer shifts in the CLM snow
combine/divide routines become short static loops of masked shifted copies.
Everything traces into the jitted substep loop.

Layer indexing: the reference uses CLM convention j in [-nlevsnow+1 ..
nlevsoil] for the snow/soil stack (negative = snow, counted up from the
soil surface).  Arrays here carry that stack on axis 0 with offset
m = j + NLEVSNOW - 1, i.e. m in [0..8]; interface arrays zi have
m = j + NLEVSNOW, m in [0..9].  Lake layers are k in [1..10] -> index k-1.

The reference's per-column LAKEDEBUG energy checks are compile-gated out in
ICAR; the always-on final energy-residual correction
(water_lake.f90:2089-2123) is kept.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..ops.indexing import take_level
import numpy as np

NLEVLAKE = 10   # water_lake.f90:45
NLEVSNOW = 5    # :46
NLEVSOIL = 4    # :44 (reduced from CLM's 10 by the ICAR port)
NSOISNO = NLEVSNOW + NLEVSOIL        # 9 snow+soil layers
NCOL = NLEVSNOW + NLEVLAKE + NLEVSOIL  # 19-level combined column

# physical constants (water_lake.f90:76-95)
VKC = 0.4
GRAV = 9.80616
SB = 5.67e-8
TFRZ = 273.16
DENH2O = 1.000e3
DENICE = 0.917e3
CPICE = 2.11727e3
CPLIQ = 4.188e3
HFUS = 3.337e5
HVAP = 2.501e6
HSUB = HVAP + HFUS
RAIR = 287.0423
CPAIR = 1.00464e3
TCRIT = 2.5
TKWAT = 0.6
TKICE = 2.290
TKAIRC = 0.023
BDSNO = 250.0
SPVAL = 1.0e36
DEPTH_C = 50.0        # :97 below this level t_lake init is 277 K

# tunable constants (:100-103)
WIMP = 0.05
SSI = 0.033
CNFAC = 0.5

# surface-flux scheme constants (ShalLakeFluxes, :722-737)
EMG = 0.97
ZII = 1000.0
BETA1 = 1.0
TDMAX = 277.0
BETA_LAKE = 0.4       # fraction of solar absorbed at surface (:791)
ZA_LAKE = 0.6         # base of surface absorption layer (:1385)

# soil texture lookup (percent sand/clay by soil type, :121-126)
SAND = np.array([92., 80., 66., 20., 5., 43., 60., 10., 32., 51., 6., 22.,
                 39.7, 0., 100., 54., 17., 100., 92.])
CLAY = np.array([3., 5., 10., 15., 5., 18., 27., 33., 33., 41., 47., 58.,
                 14.7, 0., 0., 8.5, 54., 0., 3.])

# CombineSnowLayers minimum thickness per (top-down) layer rank (:3884)
DZMIN = np.array([0.010, 0.015, 0.025, 0.055, 0.115])


def _f32(x):
    return jnp.asarray(x, jnp.float32)


def _gather_m(arr, midx):
    """arr[(L, ny, nx)] selected at per-column layer index midx[(ny, nx)]."""
    return take_level(arr, midx.astype(jnp.int32))


def _scatter_m(arr, midx, val, do):
    """Write val into arr at layer index midx where do (both (ny, nx))."""
    L = arr.shape[0]
    lay = jnp.arange(L, dtype=jnp.int32)[:, None, None]
    hit = (lay == midx[None].astype(jnp.int32)) & do[None]
    return jnp.where(hit, val[None], arr)


def _snow_mask(snl):
    """(NSOISNO, ny, nx) True where stack layer m is an active snow layer:
    j = m - 4 >= snl + 1 and j <= 0 (snow part)."""
    m = jnp.arange(NSOISNO, dtype=jnp.int32)[:, None, None]
    j = m - (NLEVSNOW - 1)
    return (j >= snl[None] + 1) & (j <= 0)


def qsat(T, p):
    """Saturation vapor pressure / specific humidity + T-derivatives
    (QSat, water_lake.f90:3327-3439; Flatau et al. 1992 polynomial fits)."""
    a = [6.11213476, 0.444007856, 0.143064234e-01, 0.264461437e-03,
         0.305903558e-05, 0.196237241e-07, 0.892344772e-10,
         -0.373208410e-12, 0.209339997e-15]
    b = [0.444017302, 0.286064092e-01, 0.794683137e-03, 0.121211669e-04,
         0.103354611e-06, 0.404125005e-09, -0.788037859e-12,
         -0.114596802e-13, 0.381294516e-16]
    c = [6.11123516, 0.503109514, 0.188369801e-01, 0.420547422e-03,
         0.614396778e-05, 0.602780717e-07, 0.387940929e-09,
         0.149436277e-11, 0.262655803e-14]
    d = [0.503277922, 0.377289173e-01, 0.126801703e-02, 0.249468427e-04,
         0.313703411e-06, 0.257180651e-08, 0.133268878e-10,
         0.394116744e-13, 0.498070196e-16]

    td = jnp.clip(T - TFRZ, -75.0, 100.0)

    def poly(coefs):
        r = _f32(coefs[-1])
        for cf in coefs[-2::-1]:
            r = cf + td * r
        return r

    warm = td >= 0.0
    es = jnp.where(warm, poly(a), poly(c)) * 100.0
    esdT = jnp.where(warm, poly(b), poly(d)) * 100.0
    vp = 1.0 / (p - 0.378 * es)
    vp1 = 0.622 * vp
    qs = es * vp1
    qsdT = esdT * vp1 * vp * p
    return es, esdT, qs, qsdT


def _stability_func1(zeta):
    """Unstable momentum stability integral (StabilityFunc1, :4748-4781)."""
    chik2 = jnp.sqrt(jnp.maximum(1.0 - 16.0 * zeta, 1e-12))
    chik = jnp.sqrt(chik2)
    return (2.0 * jnp.log((1.0 + chik) * 0.5)
            + jnp.log((1.0 + chik2) * 0.5)
            - 2.0 * jnp.arctan(chik) + jnp.pi * 0.5)


def _stability_func2(zeta):
    """Unstable scalar stability integral (StabilityFunc2, :4786-4820)."""
    chik2 = jnp.sqrt(jnp.maximum(1.0 - 16.0 * zeta, 1e-12))
    return 2.0 * jnp.log((1.0 + chik2) * 0.5)


def monin_obukhov_init(ur, thv, dthv, zldis, z0m):
    """Initial Monin-Obukhov length (MoninObukIni, :4828-4893)."""
    wc = 0.5
    um = jnp.where(dthv >= 0.0, jnp.maximum(ur, 0.1),
                   jnp.sqrt(ur * ur + wc * wc))
    rib = GRAV * zldis * dthv / (thv * um * um)
    zeta_s = rib * jnp.log(zldis / z0m) / (1.0 - 5.0 * jnp.minimum(rib, 0.19))
    zeta_s = jnp.clip(zeta_s, 0.01, 2.0)
    zeta_u = jnp.clip(rib * jnp.log(zldis / z0m), -100.0, -0.01)
    zeta = jnp.where(rib >= 0.0, zeta_s, zeta_u)
    return um, zldis / zeta


def _profile_psi(zldis, z0, obu, zeta_lim, sfunc, coef, expo):
    """Shared 4-regime flux-profile factor (FrictionVelocity, :4486-4595).

    Returns the denominator D such that scale = vkc * X / D.
    """
    zeta = zldis / obu
    safe_log = lambda x: jnp.log(jnp.maximum(x, 1e-12))
    # zeta < -zeta_lim (very unstable)
    d1 = (safe_log(-zeta_lim * obu / z0) - sfunc(-zeta_lim)
          + sfunc(z0 / obu)
          + coef * ((jnp.maximum(-zeta, 1e-12)) ** expo
                    - zeta_lim ** expo if expo > 0 else
                    (zeta_lim ** expo
                     - (jnp.maximum(-zeta, 1e-12)) ** expo)))
    # -zeta_lim <= zeta < 0 (unstable)
    d2 = (safe_log(zldis / z0) - sfunc(jnp.minimum(zeta, -1e-12))
          + sfunc(z0 / obu))
    # 0 <= zeta <= 1 (stable)
    d3 = safe_log(zldis / z0) + 5.0 * zeta - 5.0 * z0 / obu
    # zeta > 1 (very stable)
    d4 = (safe_log(jnp.maximum(obu, 1e-12) / z0) + 5.0 - 5.0 * z0 / obu
          + (5.0 * safe_log(jnp.maximum(zeta, 1.0)) + zeta - 1.0))
    return jnp.where(zeta < -zeta_lim, d1,
                     jnp.where(zeta < 0.0, d2,
                               jnp.where(zeta <= 1.0, d3, d4)))


def friction_velocity(forc_hgt_u, forc_hgt_t, forc_hgt_q, z0m, z0h, z0q,
                      obu, um):
    """Friction velocity + scalar profile relations (FrictionVelocity,
    water_lake.f90:4394-4746; Zeng et al. 1998). displa = 0 over lakes.

    Returns (ustar, temp1, temp2, temp12m, temp22m)."""
    zetam, zetat = 1.574, 0.465
    ustar = VKC * um / _profile_psi(forc_hgt_u, z0m, obu, zetam,
                                    _stability_func1, 1.14, 0.333)
    temp1 = VKC / _profile_psi(forc_hgt_t, z0h, obu, zetat,
                               _stability_func2, 0.8, -0.333)
    temp2 = VKC / _profile_psi(forc_hgt_q, z0q, obu, zetat,
                               _stability_func2, 0.8, -0.333)
    temp12m = VKC / _profile_psi(2.0 + z0h, z0h, obu, zetat,
                                 _stability_func2, 0.8, -0.333)
    temp22m = VKC / _profile_psi(2.0 + z0q, z0q, obu, zetat,
                                 _stability_func2, 0.8, -0.333)
    return ustar, temp1, temp2, temp12m, temp22m


class LakeFluxOut(NamedTuple):
    t_grnd: jnp.ndarray
    eflx_sh_grnd: jnp.ndarray
    eflx_lwrad_out: jnp.ndarray
    eflx_lwrad_net: jnp.ndarray
    eflx_soil_grnd: jnp.ndarray
    eflx_sh_tot: jnp.ndarray
    eflx_lh_tot: jnp.ndarray
    qflx_evap_soi: jnp.ndarray
    t_ref2m: jnp.ndarray
    q_ref2m: jnp.ndarray
    ws: jnp.ndarray
    ks: jnp.ndarray
    eflx_gnet: jnp.ndarray
    htvp: jnp.ndarray


def shal_lake_fluxes(forc_t, forc_pbot, forc_psrf, forc_hgt, forc_q,
                     forc_u, forc_v, forc_lwrad, sabg, lat_rad,
                     dz, dz_lake, t_soisno, t_lake, snl,
                     h2osoi_liq, h2osoi_ice, savedtke1, t_grnd, h2osno):
    """Lake surface energy balance with Monin-Obukhov iteration
    (ShalLakeFluxes, water_lake.f90:632-1170).

    All scalars of the reference's single column become (ny, nx) grids;
    the stability ITERATION loop (:906) is unrolled to its fixed 3 passes
    with the nmozsgn < 3 filter as a mask.
    """
    niters = 3
    jtop_m = snl + NLEVSNOW        # stack index of top layer (j = snl+1)

    forc_th = forc_t * (forc_psrf / forc_pbot) ** (RAIR / CPAIR)
    forc_vp = forc_q * forc_pbot / (0.622 + 0.378 * forc_q)
    forc_rho = (forc_pbot - 0.378 * forc_vp) / (RAIR * forc_t)

    snow_layers = snl < 0
    dz_top = _gather_m(dz, jtop_m)
    betaprime = jnp.where(snow_layers, 1.0, BETA_LAKE)
    dzsur = jnp.where(snow_layers, dz_top, dz_lake[0]) * 0.5

    _, _, qsatg, qsatgdT = qsat(t_grnd, forc_pbot)

    thm = forc_t + 0.0098 * forc_hgt
    thv = forc_th * (1.0 + 0.61 * forc_q)

    # roughness (:867-885 as modified by Hongping Gu)
    z0mg = jnp.where(t_grnd >= TFRZ, 0.001,
                     jnp.where(snl == 0, 0.005, 0.0024))
    z0hg = z0mg
    z0qg = z0mg
    htvp = jnp.where(t_grnd > TFRZ, HVAP, HSUB)

    ur = jnp.maximum(1.0, jnp.sqrt(forc_u ** 2 + forc_v ** 2))
    dth = thm - t_grnd
    dqh = forc_q - qsatg
    dthv = dth * (1.0 + 0.61 * forc_q) + 0.61 * forc_th * dqh
    zldis = forc_hgt

    um, obu = monin_obukhov_init(ur, thv, dthv, zldis, z0mg)

    # per-column iteration state
    nmozsgn = jnp.zeros_like(um, jnp.int32)
    obuold = jnp.zeros_like(um)
    # surface-layer conductivity/temperature (:928-944)
    ice_top = _gather_m(h2osoi_ice, jtop_m)
    liq_top = _gather_m(h2osoi_liq, jtop_m)
    bw = (ice_top + liq_top) / jnp.maximum(dz_top, 1e-12)
    tk_snow = TKAIRC + (7.75e-5 * bw + 1.105e-6 * bw * bw) * (TKICE - TKAIRC)
    t_soisno_top = _gather_m(t_soisno, jtop_m)

    unfrozen_nosnow = (t_grnd > TFRZ) & (t_lake[0] > TFRZ) & (snl == 0)
    tksur = jnp.where(unfrozen_nosnow, savedtke1,
                      jnp.where(snl == 0, TKICE, tk_snow))
    tsur = jnp.where(snow_layers, t_soisno_top, t_lake[0])

    eflx_sh_grnd = jnp.zeros_like(um)
    qflx_evap_soi = jnp.zeros_like(um)
    stftg3 = jnp.zeros_like(um)
    tgbef = t_grnd
    ram = jnp.ones_like(um)
    rah = jnp.ones_like(um)
    raw = jnp.ones_like(um)
    temp1 = jnp.ones_like(um)
    temp2 = jnp.ones_like(um)
    temp12m = jnp.ones_like(um)
    temp22m = jnp.ones_like(um)
    ustar = jnp.full_like(um, 0.06)

    for it in range(niters):
        act = nmozsgn < 3  # filter rebuild (:1012-1025)
        us_n, t1_n, t2_n, t12_n, t22_n = friction_velocity(
            forc_hgt, forc_hgt, forc_hgt, z0mg, z0hg, z0qg, obu, um)
        ustar = jnp.where(act, us_n, ustar)
        temp1 = jnp.where(act, t1_n, temp1)
        temp2 = jnp.where(act, t2_n, temp2)
        temp12m = jnp.where(act, t12_n, temp12m)
        temp22m = jnp.where(act, t22_n, temp22m)

        tgbef_n = t_grnd
        ram_n = 1.0 / (ustar * ustar / um)
        rah_n = 1.0 / (temp1 * ustar)
        raw_n = 1.0 / (temp2 * ustar)
        stftg3_n = EMG * SB * tgbef_n ** 3

        # Newton step for ground temperature (:956-966)
        ax = (betaprime * sabg + EMG * forc_lwrad + 3.0 * stftg3_n * tgbef_n
              + forc_rho * CPAIR / rah_n * thm
              - htvp * forc_rho / raw_n
              * (qsatg - qsatgdT * tgbef_n - forc_q)
              + tksur * tsur / dzsur)
        bx = (4.0 * stftg3_n + forc_rho * CPAIR / rah_n
              + htvp * forc_rho / raw_n * qsatgdT + tksur / dzsur)
        t_grnd_n = ax / bx
        htvp_n = jnp.where(t_grnd_n > TFRZ, HVAP, HSUB)

        sh_n = forc_rho * CPAIR * (t_grnd_n - thm) / rah_n
        ev_n = forc_rho * (qsatg + qsatgdT * (t_grnd_n - tgbef_n)
                           - forc_q) / raw_n

        _, _, qsatg_n, qsatgdT_n = qsat(t_grnd_n, forc_pbot)
        dth_n = thm - t_grnd_n
        dqh_n = forc_q - qsatg_n
        tstar = temp1 * dth_n
        qstar = temp2 * dqh_n
        thvstar = tstar * (1.0 + 0.61 * forc_q) + 0.61 * forc_th * qstar
        zeta = zldis * VKC * GRAV * thvstar / (ustar ** 2 * thv)
        zeta_s = jnp.clip(zeta, 0.01, 2.0)
        zeta_u = jnp.clip(zeta, -100.0, -0.01)
        wc = BETA1 * jnp.maximum(
            -GRAV * ustar * thvstar * ZII / thv, 0.0) ** 0.333
        um_s = jnp.maximum(ur, 0.1)
        um_u = jnp.sqrt(ur * ur + wc * wc)
        stable = zeta >= 0.0
        um_n = jnp.where(stable, um_s, um_u)
        obu_n = zldis / jnp.where(stable, zeta_s, zeta_u)
        nmoz_n = nmozsgn + (obuold * obu_n < 0.0).astype(jnp.int32)

        # commit only for active columns
        t_grnd = jnp.where(act, t_grnd_n, t_grnd)
        tgbef = jnp.where(act, tgbef_n, tgbef)
        htvp = jnp.where(act, htvp_n, htvp)
        eflx_sh_grnd = jnp.where(act, sh_n, eflx_sh_grnd)
        qflx_evap_soi = jnp.where(act, ev_n, qflx_evap_soi)
        qsatg = jnp.where(act, qsatg_n, qsatg)
        qsatgdT = jnp.where(act, qsatgdT_n, qsatgdT)
        dth = jnp.where(act, dth_n, dth)
        dqh = jnp.where(act, dqh_n, dqh)
        um = jnp.where(act, um_n, um)
        obu = jnp.where(act, obu_n, obu)
        obuold = jnp.where(act, obu, obuold)
        nmozsgn = jnp.where(act, nmoz_n, nmozsgn)
        ram = jnp.where(act, ram_n, ram)
        rah = jnp.where(act, rah_n, rah)
        raw = jnp.where(act, raw_n, raw)
        stftg3 = jnp.where(act, stftg3_n, stftg3)

    # post-iteration corrections (:1055-1076)
    snow_freeze_fix = ((h2osno > 0.5) | (t_lake[0] <= TFRZ)) & (t_grnd > TFRZ)
    conv_mix = (((t_lake[0] > t_grnd) & (t_grnd > TDMAX))
                | ((t_lake[0] < t_grnd) & (t_lake[0] > TFRZ)
                   & (t_grnd < TDMAX))) & ~snow_freeze_fix
    t_grnd_new = jnp.where(snow_freeze_fix, TFRZ,
                           jnp.where(conv_mix, t_lake[0], t_grnd))
    fix = snow_freeze_fix | conv_mix
    eflx_sh_grnd = jnp.where(
        fix, forc_rho * CPAIR * (t_grnd_new - thm) / rah, eflx_sh_grnd)
    qflx_evap_soi = jnp.where(
        fix, forc_rho * (qsatg + qsatgdT * (t_grnd_new - t_grnd)
                         - forc_q) / raw, qflx_evap_soi)
    t_grnd = t_grnd_new
    htvp = jnp.where(t_grnd > TFRZ, HVAP, HSUB)

    eflx_lwrad_out = (1.0 - EMG) * forc_lwrad + EMG * SB * t_grnd ** 4
    eflx_soil_grnd = (sabg + forc_lwrad - eflx_lwrad_out
                      - eflx_sh_grnd - htvp * qflx_evap_soi)
    eflx_sh_tot = eflx_sh_grnd
    eflx_lh_tot = htvp * qflx_evap_soi
    t_ref2m = thm + temp1 * dth * (1.0 / temp12m - 1.0 / temp1)
    q_ref2m = forc_q + temp2 * dqh * (1.0 / temp22m - 1.0 / temp2)
    eflx_gnet = (betaprime * sabg + forc_lwrad
                 - (eflx_lwrad_out + eflx_sh_tot + eflx_lh_tot))
    u2m = jnp.maximum(0.1, ustar / VKC * jnp.log(2.0 / z0mg))
    ws = 1.2e-03 * u2m
    ks = 6.6 * jnp.sqrt(jnp.abs(jnp.sin(lat_rad))) * u2m ** (-1.84)

    return LakeFluxOut(
        t_grnd=t_grnd, eflx_sh_grnd=eflx_sh_grnd,
        eflx_lwrad_out=eflx_lwrad_out,
        eflx_lwrad_net=eflx_lwrad_out - forc_lwrad,
        eflx_soil_grnd=eflx_soil_grnd, eflx_sh_tot=eflx_sh_tot,
        eflx_lh_tot=eflx_lh_tot, qflx_evap_soi=qflx_evap_soi,
        t_ref2m=t_ref2m, q_ref2m=q_ref2m, ws=ws, ks=ks,
        eflx_gnet=eflx_gnet, htvp=htvp)


def soil_therm_prop(snl, dz, zi, z, t_soisno, h2osoi_liq, h2osoi_ice,
                    watsat, tkmg, tkdry, tksatu, csol):
    """Snow/soil thermal conductivity and heat capacity
    (SoilThermProp_Lake, water_lake.f90:2144-2332).

    Soil follows Johansen/Farouki with the lake bed assumed saturated
    (satw = 1); snow follows Jordan (1991). Returns (tk, cv, tktopsoillay)
    where tk[m] is the interface conductivity below stack layer m.
    """
    ny, nx = snl.shape
    thk = jnp.zeros((NSOISNO, ny, nx), jnp.float32)

    # soil layers (j = 1..4 -> m = 5..8); satw = 1 (:2247)
    liq_s = h2osoi_liq[NLEVSNOW:]
    ice_s = h2osoi_ice[NLEVSNOW:]
    t_s = t_soisno[NLEVSNOW:]
    fl = liq_s / jnp.maximum(ice_s + liq_s, 1e-12)
    dksat_fr = tkmg * 0.249 ** (fl * watsat) * 2.29 ** watsat
    # unfrozen: dke = max(0, log10(1)+1) = 1 -> thk = tksatu
    thk_soil = jnp.where(t_s >= TFRZ, tksatu,
                         1.0 * dksat_fr + 0.0 * tkdry)
    thk = thk.at[NLEVSNOW:].set(thk_soil)

    # snow layers (Jordan 1991, :2264-2268)
    smask = _snow_mask(snl)
    bw = ((h2osoi_ice + h2osoi_liq)
          / jnp.maximum(dz, 1e-12))
    thk_snow = TKAIRC + (7.75e-5 * bw + 1.105e-6 * bw * bw) * (TKICE - TKAIRC)
    thk = jnp.where(smask, thk_snow, thk)

    # interface conductivity below each layer (:2280-2295)
    # j index of stack layer m is m-4; interfaces: harmonic mean except
    # j == 0 (bottom snow, bordered by lake -> return mid-layer value)
    # and j == nlevsoil (tk = 0).
    thk_p1 = jnp.concatenate([thk[1:], thk[-1:]], axis=0)
    z_p1 = jnp.concatenate([z[1:], z[-1:]], axis=0)
    tk_h = (thk * thk_p1 * (z_p1 - z)
            / jnp.maximum(thk * (z_p1 - zi[1:]) + thk_p1 * (zi[1:] - z),
                          1e-12))
    m = jnp.arange(NSOISNO, dtype=jnp.int32)[:, None, None]
    j = m - (NLEVSNOW - 1)
    tk = jnp.where(j == 0, thk,
                   jnp.where(j == NLEVSOIL, 0.0, tk_h))
    active = (j >= snl[None] + 1)
    tk = jnp.where(active, tk, 0.0)
    tktopsoillay = thk[NLEVSNOW]

    # heat capacities (:2300-2330)
    cv_soil = (csol * (1.0 - watsat) * dz[NLEVSNOW:]
               + h2osoi_ice[NLEVSNOW:] * CPICE + h2osoi_liq[NLEVSNOW:] * CPLIQ)
    cv_snow = CPLIQ * h2osoi_liq + CPICE * h2osoi_ice
    cv = jnp.where(smask, cv_snow, 0.0)
    cv = cv.at[NLEVSNOW:].set(cv_soil)
    return tk, cv, tktopsoillay


def phase_change_lake(snl, h2osno, dz, dz_lake, t_soisno, h2osoi_liq,
                      h2osoi_ice, lake_icefrac, t_lake, snowdp, cv, cv_lake):
    """Melting/freezing within snow, soil and lake layers
    (PhaseChange_Lake, water_lake.f90:2341-2559).

    Returns updated (h2osno, snowdp, t_soisno, h2osoi_liq, h2osoi_ice,
    lake_icefrac, t_lake, cv, cv_lake, qflx_snomelt, eflx_snomelt, imelt,
    lhabs)."""
    small = 1e-7
    qflx_snomelt = jnp.zeros_like(h2osno)
    lhabs = jnp.zeros_like(h2osno)
    imelt = jnp.zeros_like(t_soisno, jnp.int32)

    # snow without layers atop an unfrozen top lake layer (:2466-2483)
    c0 = (snl == 0) & (h2osno > 0.0) & (t_lake[0] > TFRZ)
    heatavail = (t_lake[0] - TFRZ) * cv_lake[0]
    melt0 = jnp.minimum(h2osno, heatavail / HFUS)
    heatrem0 = jnp.maximum(heatavail - melt0 * HFUS, 0.0)
    t_lake0 = jnp.where(c0, TFRZ + heatrem0 / cv_lake[0], t_lake[0])
    snowdp = jnp.where(c0, snowdp * (1.0 - melt0 / jnp.maximum(h2osno, small)),
                       snowdp)
    h2osno = jnp.where(c0, h2osno - melt0, h2osno)
    lhabs = lhabs + jnp.where(c0, melt0 * HFUS, 0.0)
    qflx_snomelt = qflx_snomelt + jnp.where(c0, melt0, 0.0)
    h2osno = jnp.where(c0 & (h2osno < small), 0.0, h2osno)
    snowdp = jnp.where(c0 & (snowdp < small), 0.0, snowdp)
    t_lake = t_lake.at[0].set(t_lake0)

    # lake layer phase change (:2487-2521)
    heatavail_l = (t_lake - TFRZ) * cv_lake
    melting = (t_lake > TFRZ) & (lake_icefrac > 0.0)
    freezing = (t_lake < TFRZ) & (lake_icefrac < 1.0)
    melt_l = jnp.where(
        melting,
        jnp.minimum(lake_icefrac * DENH2O * dz_lake, heatavail_l / HFUS),
        jnp.where(freezing,
                  jnp.maximum(-(1.0 - lake_icefrac) * DENH2O * dz_lake,
                              heatavail_l / HFUS), 0.0))
    heatrem_l = jnp.where(
        melting, jnp.maximum(heatavail_l - melt_l * HFUS, 0.0),
        jnp.minimum(heatavail_l - melt_l * HFUS, 0.0))
    change_l = melting | freezing
    lake_icefrac = jnp.where(
        change_l, lake_icefrac - melt_l / (DENH2O * dz_lake), lake_icefrac)
    lhabs = lhabs + jnp.sum(jnp.where(change_l, melt_l * HFUS, 0.0), axis=0)
    cv_lake = jnp.where(change_l, cv_lake + melt_l * (CPLIQ - CPICE), cv_lake)
    t_lake = jnp.where(change_l, TFRZ + heatrem_l / cv_lake, t_lake)
    lake_icefrac = jnp.where(lake_icefrac > 1.0 - small, 1.0, lake_icefrac)
    lake_icefrac = jnp.where(lake_icefrac < small, 0.0, lake_icefrac)

    # snow & soil phase change (:2525-2568)
    m = jnp.arange(NSOISNO, dtype=jnp.int32)[:, None, None]
    j = m - (NLEVSNOW - 1)
    active = j >= snl[None] + 1
    is_snow = j <= 0
    heatavail_s = (t_soisno - TFRZ) * cv
    melt_cond = active & (t_soisno > TFRZ) & (h2osoi_ice > 0.0)
    frz_cond = active & (t_soisno < TFRZ) & (h2osoi_liq > 0.0) & ~melt_cond
    melt_s = jnp.where(
        melt_cond, jnp.minimum(h2osoi_ice, heatavail_s / HFUS),
        jnp.where(frz_cond,
                  jnp.maximum(-h2osoi_liq, heatavail_s / HFUS), 0.0))
    heatrem_s = jnp.where(
        melt_cond, jnp.maximum(heatavail_s - melt_s * HFUS, 0.0),
        jnp.minimum(heatavail_s - melt_s * HFUS, 0.0))
    change_s = melt_cond | frz_cond
    imelt = jnp.where(melt_cond & is_snow, 1,
                      jnp.where(frz_cond & is_snow, 2, 0)).astype(jnp.int32)
    qflx_snomelt = qflx_snomelt + jnp.sum(
        jnp.where(change_s & is_snow, melt_s, 0.0), axis=0)
    h2osoi_ice = jnp.where(change_s, h2osoi_ice - melt_s, h2osoi_ice)
    h2osoi_liq = jnp.where(change_s, h2osoi_liq + melt_s, h2osoi_liq)
    lhabs = lhabs + jnp.sum(jnp.where(change_s, melt_s * HFUS, 0.0), axis=0)
    cv = jnp.where(change_s, cv + melt_s * (CPLIQ - CPICE), cv)
    t_soisno = jnp.where(change_s,
                         TFRZ + heatrem_s / jnp.maximum(cv, 1e-12), t_soisno)
    h2osoi_ice = jnp.where(change_s & (h2osoi_ice < small), 0.0, h2osoi_ice)
    h2osoi_liq = jnp.where(change_s & (h2osoi_liq < small), 0.0, h2osoi_liq)

    # NOTE reference units quirk preserved: qflx_snomelt accumulates melt
    # MASS (kg/m2) over the step, never divided by dtime
    # (water_lake.f90:2479,2540,2551); both downstream consumers
    # (eflx_snomelt, SnowWater's qflx_top_soil) are unused diagnostics.
    eflx_snomelt = qflx_snomelt * HFUS
    return (h2osno, snowdp, t_soisno, h2osoi_liq, h2osoi_ice, lake_icefrac,
            t_lake, cv, cv_lake, qflx_snomelt, eflx_snomelt, imelt, lhabs)


def _tridiag_column(a, b, c, r, active, is_top):
    """Thomas solve over the static layer axis with per-column variable top
    (Tridiagonal, water_lake.f90:3442-3524).

    Inactive rows (above jtop) are replaced by identity rows, which leaves
    the filtered recurrence exactly intact because the top active row has
    a = 0 and identity rows have c = 0."""
    one = jnp.ones_like(b[0])
    zero = jnp.zeros_like(b[0])
    a = jnp.where(active, a, 0.0)
    b = jnp.where(active, b, 1.0)
    c = jnp.where(active, c, 0.0)
    # sanitize r too: inactive rows can hold NaN/inf from zeroed geometry,
    # and 0 * NaN at the first active row would poison the sweep
    r = jnp.where(active, r, 0.0)
    n = a.shape[0]
    # forward sweep
    gam = [zero] * n
    u = [zero] * n
    bet = b[0]
    u[0] = r[0] / bet
    for k in range(1, n):
        gam[k] = c[k - 1] / bet
        bet = b[k] - a[k] * gam[k]
        u[k] = (r[k] - a[k] * u[k - 1]) / bet
    for k in range(n - 2, -1, -1):
        u[k] = u[k] - gam[k + 1] * u[k + 1]
    return jnp.stack(u)


def _lake_density(t_lake, lake_icefrac):
    """Water density with ice weighting (water_lake.f90:1463-1470)."""
    return ((1.0 - lake_icefrac) * 1000.0
            * (1.0 - 1.9549e-05 * jnp.abs(t_lake - 277.0) ** 1.68)
            + lake_icefrac * DENICE)


def shal_lake_temperature(t_grnd, h2osno, sabg, dz, dz_lake, z, zi, z_lake,
                          ws, ks, snl, eflx_gnet, lakedepth, lake_icefrac,
                          snowdp, t_lake, t_soisno, h2osoi_liq, h2osoi_ice,
                          watsat, tkmg, tkdry, tksatu, csol,
                          eflx_sh_grnd, eflx_sh_tot, eflx_soil_grnd, dtime):
    """Crank-Nicolson diffusion through the snow/lake/soil column with
    Hostetler eddy diffusivity, solar absorption, phase change and
    convective mixing (ShalLakeTemperature, water_lake.f90:1172-2135).

    Returns a dict of the updated state + flux corrections."""
    cwat = CPLIQ * DENH2O
    cice_eff = CPICE * DENH2O
    cfus = HFUS * DENH2O
    tkice_eff = TKICE * DENICE / DENH2O
    km = TKWAT / cwat

    m9 = jnp.arange(NSOISNO, dtype=jnp.int32)[:, None, None]
    j9 = m9 - (NLEVSNOW - 1)
    act9 = j9 >= snl[None] + 1
    smask = _snow_mask(snl)

    # previous-step ice fraction of snow (:1424-1434)
    frac_iceold = jnp.where(
        smask, h2osoi_ice / jnp.maximum(h2osoi_liq + h2osoi_ice, 1e-12), 0.0)

    fin = eflx_gnet

    # 2) lake density / 3) diffusivity (:1457-1531)
    rhow = _lake_density(t_lake, lake_icefrac)
    drhodz = (rhow[1:] - rhow[:-1]) / (z_lake[1:] - z_lake[:-1])
    n2 = GRAV / rhow[:-1] * drhodz
    zl = z_lake[:-1]
    num = 40.0 * n2 * (VKC * zl) ** 2
    den = jnp.maximum((ws ** 2) * jnp.exp(-2.0 * ks * zl), 1e-10)
    ri = (-1.0 + jnp.sqrt(jnp.maximum(1.0 + num / den, 0.0))) / 20.0
    unfrozen = (t_grnd > TFRZ) & (t_lake[0] > TFRZ) & (snl == 0)
    ke_base = VKC * ws * zl * jnp.exp(-ks * zl) / (1.0 + 37.0 * ri * ri)
    # enhanced mixing factors for deep lakes (:1506-1525, mchen)
    warm = t_lake[0] > 277.15
    fac_warm = jnp.where(lakedepth > 15.0, 1.0e2, 1.0)
    fac_cold = jnp.where(lakedepth > 150.0, 1.0e5,
                         jnp.where(lakedepth > 15.0, 1.0e4, 1.0))
    ke = ke_base * jnp.where(warm, fac_warm, fac_cold)
    tk_frozen = (TKWAT * tkice_eff
                 / ((1.0 - lake_icefrac[:-1]) * tkice_eff
                    + TKWAT * lake_icefrac[:-1]))
    kme_i = jnp.where(unfrozen, km + ke, km)
    tk_lake_i = jnp.where(unfrozen, (km + ke) * cwat, tk_frozen)
    # bottom lake layer (:1535-1550)
    kme = jnp.concatenate([kme_i, kme_i[-1:]], axis=0)
    tk_bot_frozen = (TKWAT * tkice_eff
                     / ((1.0 - lake_icefrac[-1:]) * tkice_eff
                        + TKWAT * lake_icefrac[-1:]))
    tk_lake = jnp.concatenate(
        [tk_lake_i, jnp.where(unfrozen, tk_lake_i[-1:], tk_bot_frozen)],
        axis=0)
    savedtke1 = kme[0] * cwat

    # 4) solar source (:1554-1596); eta from Hakanson 1995
    eta = 1.1925 * jnp.maximum(lakedepth, 1e-3) ** (-0.424)
    zin = z_lake - 0.5 * dz_lake
    zout = z_lake + 0.5 * dz_lake
    rsfin = jnp.exp(-eta * jnp.maximum(zin - ZA_LAKE, 0.0))
    rsfout = jnp.exp(-eta * jnp.maximum(zout - ZA_LAKE, 0.0))
    frozen_nosnow = (~unfrozen) & (snl == 0)
    k1 = (jnp.arange(NLEVLAKE)[:, None, None] == 0)
    phi = jnp.where(unfrozen[None],
                    (rsfin - rsfout) * sabg[None] * (1.0 - BETA_LAKE),
                    jnp.where(frozen_nosnow[None] & k1,
                              sabg[None] * (1.0 - BETA_LAKE), 0.0))
    phi_soil = jnp.where(unfrozen, rsfout[-1] * sabg * (1.0 - BETA_LAKE), 0.0)

    # 5) thermal properties + old energy content (:1600-1653)
    cv_lake = dz_lake * (cwat * (1.0 - lake_icefrac) + cice_eff * lake_icefrac)
    tk, cv, tktopsoillay = soil_therm_prop(
        snl, dz, zi, z, t_soisno, h2osoi_liq, h2osoi_ice,
        watsat, tkmg, tkdry, tksatu, csol)

    ocvts = jnp.sum(cv_lake * (t_lake - TFRZ)
                    + cfus * dz_lake * (1.0 - lake_icefrac), axis=0)
    ocvts = ocvts + jnp.sum(
        jnp.where(act9, cv * (t_soisno - TFRZ) + HFUS * h2osoi_liq, 0.0),
        axis=0)
    # thin-snow correction (:1649): j == 1 is never jtop for lakes with
    # snow present, but the reference checks j==1==jtop & h2osno>0 -> only
    # possible when snl == 0 and the soil top is the column top; the lake
    # column's jtop is snl+1 <= 1 only through snow/soil stack, never soil
    # layer 1 (lake layers sit between) -> condition reduces to snl == 0.
    ocvts = ocvts - jnp.where((snl == 0) & (h2osno > 0.0),
                              h2osno * HFUS, 0.0)

    # 6) whole-column assembly (:1662-1775); column index cidx = jcol+4,
    # jcol in [-4..14]: snow jcol<=0 -> stack m=jcol+4; lake 1..10 ->
    # k=jcol-1; soil 11..14 -> stack m=jcol-10+4
    ny, nx = snl.shape
    zx = jnp.zeros((NCOL, ny, nx), jnp.float32)
    cvx = jnp.zeros((NCOL, ny, nx), jnp.float32)
    phix = jnp.zeros((NCOL, ny, nx), jnp.float32)
    tx = jnp.zeros((NCOL, ny, nx), jnp.float32)

    snow_sl = slice(0, NLEVSNOW)
    lake_sl = slice(NLEVSNOW, NLEVSNOW + NLEVLAKE)
    soil_sl = slice(NLEVSNOW + NLEVLAKE, NCOL)

    zx = zx.at[snow_sl].set(z[:NLEVSNOW])
    zx = zx.at[lake_sl].set(z_lake)
    z_soil_base = z_lake[-1] + 0.5 * dz_lake[-1]
    zx = zx.at[soil_sl].set(z_soil_base[None] + z[NLEVSNOW:])

    cvx = cvx.at[snow_sl].set(cv[:NLEVSNOW])
    cvx = cvx.at[lake_sl].set(cv_lake)
    cvx = cvx.at[soil_sl].set(cv[NLEVSNOW:])

    phix = phix.at[lake_sl].set(phi)
    phix = phix.at[NLEVSNOW + NLEVLAKE].set(phi_soil)

    tx = tx.at[snow_sl].set(t_soisno[:NLEVSNOW])
    tx = tx.at[lake_sl].set(t_lake)
    tx = tx.at[soil_sl].set(t_soisno[NLEVSNOW:])

    # interface conductivities tkix (:1697-1723)
    tkix = jnp.zeros((NCOL, ny, nx), jnp.float32)
    # snow layers above the bottom one: tk at same stack index
    tkix = tkix.at[snow_sl].set(tk[:NLEVSNOW])
    # bottom snow layer (jcol == 0, cidx 4): snow-lake interface
    dzp0 = zx[NLEVSNOW] - zx[NLEVSNOW - 1]
    tk_bot_snow = (tk_lake[0] * tk[NLEVSNOW - 1] * dzp0
                   / (tk[NLEVSNOW - 1] * z_lake[0]
                      + tk_lake[0] * jnp.maximum(-z[NLEVSNOW - 1], 1e-12)))
    tkix = tkix.at[NLEVSNOW - 1].set(tk_bot_snow)
    # non-bottom lake layers: harmonic mean weighted by dz
    tk_lk = (tk_lake[:-1] * tk_lake[1:] * (dz_lake[1:] + dz_lake[:-1])
             / (tk_lake[:-1] * dz_lake[1:] + tk_lake[1:] * dz_lake[:-1]))
    tkix = tkix.at[NLEVSNOW:NLEVSNOW + NLEVLAKE - 1].set(tk_lk)
    # bottom lake layer (jcol == nlevlake): lake-soil interface
    dzp_b = zx[NLEVSNOW + NLEVLAKE] - zx[NLEVSNOW + NLEVLAKE - 1]
    tk_lake_soil = (tktopsoillay * tk_lake[-1] * dzp_b
                    / (tktopsoillay * dz_lake[-1] * 0.5
                       + tk_lake[-1] * z[NLEVSNOW]))
    tkix = tkix.at[NLEVSNOW + NLEVLAKE - 1].set(tk_lake_soil)
    tkix = tkix.at[soil_sl].set(tk[NLEVSNOW:])

    # active column mask: cidx >= jtop+4, jtop = snl+1
    cidx = jnp.arange(NCOL, dtype=jnp.int32)[:, None, None]
    top_cidx = (snl + NLEVSNOW)[None]
    act = cidx >= top_cidx
    is_top = cidx == top_cidx

    # heat flux factors (:1730-1747)
    factx = dtime / jnp.maximum(cvx, 1e-12)
    dz_below = jnp.concatenate(
        [zx[1:] - zx[:-1], jnp.ones_like(zx[:1])], axis=0)
    tx_p1 = jnp.concatenate([tx[1:], tx[-1:]], axis=0)
    fnx = jnp.where(cidx < NCOL - 1,
                    tkix * (tx_p1 - tx) / dz_below, 0.0)

    # tridiagonal coefficients (:1749-1775)
    dzm = jnp.concatenate([jnp.ones_like(zx[:1]), zx[1:] - zx[:-1]], axis=0)
    dzp = dz_below
    fnx_m1 = jnp.concatenate([jnp.zeros_like(fnx[:1]), fnx[:-1]], axis=0)
    not_bottom = cidx < NCOL - 1
    a_mid = -(1.0 - CNFAC) * factx * jnp.where(
        cidx > 0, tkix_m1 := jnp.concatenate(
            [jnp.zeros_like(tkix[:1]), tkix[:-1]], axis=0), 0.0) / dzm
    b_mid = 1.0 + (1.0 - CNFAC) * factx * (
        jnp.where(not_bottom, tkix / dzp, 0.0) + tkix_m1 / dzm)
    c_mid = -(1.0 - CNFAC) * factx * jnp.where(not_bottom, tkix / dzp, 0.0)
    r_mid = (tx + CNFAC * factx * (jnp.where(not_bottom, fnx, 0.0) - fnx_m1)
             + factx * phix)
    # top row overrides
    a_top = jnp.zeros_like(a_mid)
    b_top = 1.0 + (1.0 - CNFAC) * factx * tkix / dzp
    c_top = -(1.0 - CNFAC) * factx * tkix / dzp
    r_top = tx + factx * (fin[None] + phix + CNFAC * fnx)
    a = jnp.where(is_top, a_top, a_mid)
    b = jnp.where(is_top, b_top, b_mid)
    c = jnp.where(is_top, c_top, c_mid)
    r = jnp.where(is_top, r_top, r_mid)

    # 7) solve + scatter back (:1781-1811)
    tx_new = _tridiag_column(a, b, c, r, act, is_top)
    t_soisno = t_soisno.at[:NLEVSNOW].set(
        jnp.where(act[snow_sl], tx_new[snow_sl], t_soisno[:NLEVSNOW]))
    t_lake = tx_new[lake_sl]
    t_soisno = t_soisno.at[NLEVSNOW:].set(tx_new[soil_sl])

    # 9) phase change (:1861-1867)
    (h2osno, snowdp, t_soisno, h2osoi_liq, h2osoi_ice, lake_icefrac, t_lake,
     cv, cv_lake, qflx_snomelt, eflx_snomelt, imelt, lhabs) = \
        phase_change_lake(snl, h2osno, dz, dz_lake, t_soisno, h2osoi_liq,
                          h2osoi_ice, lake_icefrac, t_lake, snowdp,
                          cv, cv_lake)

    # 10) convective mixing (:1945-2032): sequential down the lake column
    rhow = _lake_density(t_lake, lake_icefrac)
    for jmix in range(NLEVLAKE - 1):
        trig = ((rhow[jmix] > rhow[jmix + 1])
                | ((lake_icefrac[jmix] < 1.0)
                   & (lake_icefrac[jmix + 1] > 0.0)))
        lay = jnp.arange(NLEVLAKE)[:, None, None]
        in_mix = lay <= jmix + 1
        cvw = (1.0 - lake_icefrac) * cwat + lake_icefrac * cice_eff
        qav = jnp.sum(jnp.where(in_mix,
                                dz_lake * (t_lake - TFRZ) * cvw, 0.0), axis=0)
        iceav_t = jnp.sum(jnp.where(in_mix, lake_icefrac * dz_lake, 0.0),
                          axis=0)
        nav = jnp.sum(jnp.where(in_mix, dz_lake, 0.0), axis=0)
        qav = qav / nav
        iceav = iceav_t / nav
        tav_froz = jnp.where(qav < 0.0,
                             qav / jnp.maximum(iceav * cice_eff, 1e-12), 0.0)
        tav_unfr = jnp.where(qav > 0.0,
                             qav / jnp.maximum((1.0 - iceav) * cwat, 1e-12),
                             0.0)
        # redistribute: all ice at the top (:1993-2030)
        zsum = jnp.cumsum(dz_lake, axis=0) - dz_lake   # depth above layer i
        frac_hi = (zsum + dz_lake) / nav[None] <= iceav[None]
        frac_part = (zsum / nav[None] < iceav[None]) & ~frac_hi
        icef_new = jnp.where(
            frac_hi, 1.0,
            jnp.where(frac_part,
                      (iceav[None] * nav[None] - zsum) / dz_lake, 0.0))
        t_part = ((icef_new * tav_froz[None] * cice_eff
                   + (1.0 - icef_new) * tav_unfr[None] * cwat)
                  / (icef_new * cice_eff + (1.0 - icef_new) * cwat) + TFRZ)
        t_new = jnp.where(frac_hi, tav_froz[None] + TFRZ,
                          jnp.where(frac_part, t_part,
                                    tav_unfr[None] + TFRZ))
        apply = trig[None] & in_mix
        lake_icefrac = jnp.where(apply, icef_new, lake_icefrac)
        t_lake = jnp.where(apply, t_new, t_lake)
        rhow = jnp.where(apply, _lake_density(t_lake, lake_icefrac), rhow)

    # 11) re-evaluate properties, new energy content, residual fix
    # (:2037-2123)
    cv_lake = dz_lake * (cwat * (1.0 - lake_icefrac) + cice_eff * lake_icefrac)
    tk, cv, tktopsoillay = soil_therm_prop(
        snl, dz, zi, z, t_soisno, h2osoi_liq, h2osoi_ice,
        watsat, tkmg, tkdry, tksatu, csol)
    ncvts = jnp.sum(cv_lake * (t_lake - TFRZ)
                    + cfus * dz_lake * (1.0 - lake_icefrac), axis=0)
    ncvts = ncvts + jnp.sum(
        jnp.where(act9, cv * (t_soisno - TFRZ) + HFUS * h2osoi_liq, 0.0),
        axis=0)
    ncvts = ncvts - jnp.where((snl == 0) & (h2osno > 0.0),
                              h2osno * HFUS, 0.0)
    fin_tot = fin + jnp.sum(phi, axis=0) + phi_soil
    errsoi = (ncvts - ocvts) / dtime - fin_tot
    fixable = jnp.abs(errsoi) < 10.0
    eflx_sh_tot = eflx_sh_tot - jnp.where(fixable, errsoi, 0.0)
    eflx_sh_grnd = eflx_sh_grnd - jnp.where(fixable, errsoi, 0.0)
    eflx_soil_grnd = eflx_soil_grnd + jnp.where(fixable, errsoi, 0.0)
    eflx_gnet = eflx_gnet + jnp.where(fixable, errsoi, 0.0)

    return dict(
        t_lake=t_lake, t_soisno=t_soisno, h2osoi_liq=h2osoi_liq,
        h2osoi_ice=h2osoi_ice, lake_icefrac=lake_icefrac, h2osno=h2osno,
        snowdp=snowdp, savedtke1=savedtke1, frac_iceold=frac_iceold,
        qflx_snomelt=qflx_snomelt, imelt=imelt,
        eflx_sh_grnd=eflx_sh_grnd, eflx_sh_tot=eflx_sh_tot,
        eflx_soil_grnd=eflx_soil_grnd, eflx_gnet=eflx_gnet,
        errsoi=errsoi)


def snow_water(snl, qflx_snomelt, qflx_rain_grnd, qflx_sub_snow,
               qflx_evap_grnd, qflx_dew_snow, qflx_dew_grnd, dz,
               h2osoi_ice, h2osoi_liq, dtime):
    """Snow mass change + gravitational percolation (SnowWater,
    water_lake.f90:3527-3689). do_capsnow is always false in the ICAR
    driver (lsm_driver.f90: do_capsnow(c)=.false.), so the capping branch
    is omitted. Returns (h2osoi_ice, h2osoi_liq, qflx_top_soil)."""
    has_snow = snl < 0
    jtop_m = snl + NLEVSNOW

    # top-layer sublimation / dew (:3601-3618)
    ice_top = _gather_m(h2osoi_ice, jtop_m)
    liq_top = _gather_m(h2osoi_liq, jtop_m)
    wgdif = ice_top + (qflx_dew_snow - qflx_sub_snow) * dtime
    liq_new = jnp.where(wgdif < 0.0, liq_top + wgdif, liq_top)
    ice_new = jnp.maximum(wgdif, 0.0)
    liq_new = liq_new + (qflx_rain_grnd + qflx_dew_grnd
                         - qflx_evap_grnd) * dtime
    liq_new = jnp.maximum(0.0, liq_new)
    h2osoi_ice = _scatter_m(h2osoi_ice, jtop_m, ice_new, has_snow)
    h2osoi_liq = _scatter_m(h2osoi_liq, jtop_m, liq_new, has_snow)

    # porosity & partial volumes over snow layers (:3622-3633)
    smask = _snow_mask(snl)
    dz_s = jnp.maximum(dz, 1e-12)
    vol_ice = jnp.minimum(1.0, h2osoi_ice / (dz_s * DENICE))
    eff_por = 1.0 - vol_ice
    vol_liq = jnp.minimum(eff_por, h2osoi_liq / (dz_s * DENH2O))

    # gravitational drainage, top-down sequential (:3644-3669)
    ny, nx = snl.shape
    qin = jnp.zeros((ny, nx), jnp.float32)
    liq = h2osoi_liq
    for m in range(NLEVSNOW):         # j = m - 4 in [-4 .. 0]
        act = smask[m]
        lm = jnp.where(act, liq[m] + qin, liq[m])
        if m < NLEVSNOW - 1:
            blocked = (eff_por[m] < WIMP) | (eff_por[m + 1] < WIMP)
            qout = jnp.where(
                blocked, 0.0,
                jnp.maximum(0.0, (vol_liq[m] - SSI * eff_por[m]) * dz[m]))
            qout = jnp.minimum(
                qout, (1.0 - vol_ice[m + 1] - vol_liq[m + 1]) * dz[m + 1])
        else:
            qout = jnp.maximum(0.0, (vol_liq[m] - SSI * eff_por[m]) * dz[m])
        qout = qout * 1000.0
        lm = lm - jnp.where(act, qout, 0.0)
        liq = liq.at[m].set(lm)
        qin = jnp.where(act, qout, qin)

    qflx_top_soil = jnp.where(has_snow, qin / dtime,
                              qflx_rain_grnd + qflx_snomelt)
    return h2osoi_ice, liq, qflx_top_soil


def snow_compaction(snl, imelt, frac_iceold, t_soisno, h2osoi_ice,
                    h2osoi_liq, dz, dtime):
    """Destructive / overburden / melt metamorphism (SnowCompaction,
    water_lake.f90:3691-3819; SNTHERM.89)."""
    c2, c3, c4, c5 = 23.0e-3, 2.777e-6, 0.04, 2.0
    dm, eta0 = 100.0, 9.0e5
    smask = _snow_mask(snl)
    burden = jnp.zeros_like(snl, jnp.float32)
    dz_new = dz
    for m in range(NLEVSNOW):
        act = smask[m]
        wx = h2osoi_ice[m] + h2osoi_liq[m]
        dzm = jnp.maximum(dz[m], 1e-12)
        void = 1.0 - (h2osoi_ice[m] / DENICE + h2osoi_liq[m] / DENH2O) / dzm
        compact = act & (void > 0.001) & (h2osoi_ice[m] > 0.1)
        bi = h2osoi_ice[m] / dzm
        fi = h2osoi_ice[m] / jnp.maximum(wx, 1e-12)
        td = TFRZ - t_soisno[m]
        dexpf = jnp.exp(-c4 * td)
        ddz1 = -c3 * dexpf
        ddz1 = jnp.where(bi > dm, ddz1 * jnp.exp(-46.0e-3 * (bi - dm)), ddz1)
        ddz1 = jnp.where(h2osoi_liq[m] > 0.01 * dzm, ddz1 * c5, ddz1)
        ddz2 = -burden * jnp.exp(-0.08 * td - c2 * bi) / eta0
        fio = jnp.maximum(frac_iceold[m], 1e-12)
        ddz3 = jnp.where(imelt[m] == 1,
                         -1.0 / dtime * jnp.maximum(0.0, (fio - fi) / fio),
                         0.0)
        pdzdtc = ddz1 + ddz2 + ddz3
        dz_new = dz_new.at[m].set(
            jnp.where(compact, dz[m] * (1.0 + pdzdtc * dtime), dz_new[m]))
        burden = burden + jnp.where(act, wx, 0.0)
    return dz_new


def combo(dz1, liq1, ice1, t1, dz2, liq2, ice2, t2):
    """Enthalpy-conserving merge of two snow elements (Combo,
    water_lake.f90:4272-4335). Element 2 merges INTO element 1."""
    dzc = dz1 + dz2
    wicec = ice1 + ice2
    wliqc = liq1 + liq2
    h = (CPICE * ice1 + CPLIQ * liq1) * (t1 - TFRZ) + HFUS * liq1
    h2 = (CPICE * ice2 + CPLIQ * liq2) * (t2 - TFRZ) + HFUS * liq2
    hc = h + h2
    cpc = jnp.maximum(CPICE * wicec + CPLIQ * wliqc, 1e-12)
    tc = jnp.where(hc < 0.0, TFRZ + hc / cpc,
                   jnp.where(hc <= HFUS * wliqc, TFRZ,
                             TFRZ + (hc - HFUS * wliqc) / cpc))
    return dzc, wliqc, wicec, tc


def _shift_down(arrs, shift_mask):
    """layer[m] <- layer[m-1] where shift_mask[m] (a masked roll)."""
    out = []
    for a in arrs:
        rolled = jnp.concatenate([a[:1], a[:-1]], axis=0)
        out.append(jnp.where(shift_mask, rolled, a))
    return out


def combine_snow_layers(snl, h2osno, snowdp, dz, zi, t_soisno, h2osoi_ice,
                        h2osoi_liq, z):
    """Merge snow layers below minimum thickness/mass (CombineSnowLayers,
    water_lake.f90:3821-4042). The reference's sequential per-column layer
    shifts become static loops of masked rolls."""
    m_ax = jnp.arange(NSOISNO, dtype=jnp.int32)[:, None, None]
    j_ax = m_ax - (NLEVSNOW - 1)

    # -- pass 1: remove ice-poor layers (:3902-3928)
    msn_old = snl
    for j in range(-NLEVSNOW + 1, 1):        # j = -4..0
        m = j + NLEVSNOW - 1
        do = (j >= msn_old + 1) & (h2osoi_ice[m] <= 0.1)
        # dump into layer below (j+1; j=0 dumps into the top soil layer)
        h2osoi_liq = h2osoi_liq.at[m + 1].add(jnp.where(do, h2osoi_liq[m], 0.0))
        h2osoi_ice = h2osoi_ice.at[m + 1].add(jnp.where(do, h2osoi_ice[m], 0.0))
        # shift layers snl+1..j-1 down one slot (into snl+2..j)
        shift = do[None] & (j_ax <= j) & (j_ax >= snl[None] + 2)
        t_soisno, h2osoi_liq, h2osoi_ice, dz = _shift_down(
            (t_soisno, h2osoi_liq, h2osoi_ice, dz), shift)
        snl = jnp.where(do, snl + 1, snl)

    # -- totals (:3930-3953)
    smask = _snow_mask(snl)
    h2osno = jnp.sum(jnp.where(smask, h2osoi_ice + h2osoi_liq, 0.0), axis=0)
    snowdp = jnp.sum(jnp.where(smask, dz, 0.0), axis=0)
    zwice = jnp.sum(jnp.where(smask, h2osoi_ice, 0.0), axis=0)

    # -- all snow gone (:3959-3967); NOTE the liquid is dropped for lake
    # columns exactly as in the reference (the istsoil recovery is
    # commented out at :3966)
    gone = (snowdp < 0.01) & (snowdp > 0.0)
    snl = jnp.where(gone, 0, snl)
    h2osno = jnp.where(gone, zwice, h2osno)
    snowdp = jnp.where(gone & (h2osno <= 0.0), 0.0, snowdp)

    # -- pass 2: combine layers thinner than dzmin (:3972-4040)
    msn_old2 = snl
    mssi = jnp.ones_like(snl, jnp.int32)
    dzmin = jnp.asarray(DZMIN, jnp.float32)
    for i in range(-NLEVSNOW + 1, 1):        # i = -4..0
        mi = i + NLEVSNOW - 1
        act = (snl < -1) & (i >= msn_old2 + 1)
        thin = dz[mi] < dzmin[jnp.clip(mssi - 1, 0, NLEVSNOW - 1)]
        do = act & thin
        is_top = i == (snl + 1)
        is_bot = i == 0
        dz_m1 = dz[max(mi - 1, 0)]
        dz_p1 = dz[min(mi + 1, NSOISNO - 1)]
        neibor = jnp.where(
            is_top, i + 1,
            jnp.where(is_bot, i - 1,
                      jnp.where(dz_m1 + dz[mi] < dz_p1 + dz[mi],
                                i - 1, i + 1))).astype(jnp.int32)
        jidx = jnp.maximum(i, neibor) + NLEVSNOW - 1   # combined goes here
        lidx = jnp.minimum(i, neibor) + NLEVSNOW - 1
        dzc, liqc, icec, tc = combo(
            _gather_m(dz, jidx), _gather_m(h2osoi_liq, jidx),
            _gather_m(h2osoi_ice, jidx), _gather_m(t_soisno, jidx),
            _gather_m(dz, lidx), _gather_m(h2osoi_liq, lidx),
            _gather_m(h2osoi_ice, lidx), _gather_m(t_soisno, lidx))
        dz = _scatter_m(dz, jidx, dzc, do)
        h2osoi_liq = _scatter_m(h2osoi_liq, jidx, liqc, do)
        h2osoi_ice = _scatter_m(h2osoi_ice, jidx, icec, do)
        t_soisno = _scatter_m(t_soisno, jidx, tc, do)
        # shift layers snl+1..j-2 down into snl+2..j-1 (vacating l)
        shift = do[None] & (m_ax <= jidx[None] - 1) & (j_ax >= snl[None] + 2)
        t_soisno, h2osoi_liq, h2osoi_ice, dz = _shift_down(
            (t_soisno, h2osoi_liq, h2osoi_ice, dz), shift)
        snl = jnp.where(do, snl + 1, snl)
        mssi = jnp.where(act & ~thin, mssi + 1, mssi)

    # -- reset node depths from interfaces (:4027-4040)
    z, zi = _rebuild_snow_geometry(snl, dz, z, zi)
    return snl, h2osno, snowdp, dz, zi, t_soisno, h2osoi_ice, h2osoi_liq, z


def _rebuild_snow_geometry(snl, dz, z, zi):
    """z/zi from dz for active snow layers, downward from the surface
    (water_lake.f90:4027-4040 and :4274-4287): z[j] = zi[j] - dz[j]/2,
    zi[j-1] = zi[j] - dz[j], with zi(0) = 0 at the snow/lake interface."""
    smask = _snow_mask(snl)
    for m in range(NLEVSNOW - 1, -1, -1):    # j = 0 down to -4
        act = smask[m]
        # zi index of "below layer m" is m+1
        z = z.at[m].set(jnp.where(act, zi[m + 1] - 0.5 * dz[m], z[m]))
        zi = zi.at[m].set(jnp.where(act, zi[m + 1] - dz[m], zi[m]))
    return z, zi


def divide_snow_layers(snl, dz, zi, t_soisno, h2osoi_ice, h2osoi_liq, z):
    """Subdivide over-thick snow layers (DivideSnowLayers,
    water_lake.f90:4044-4270). Runs in top-down compressed coordinates
    (rank k = j - snl), then scatters back to the CLM stack."""
    ny, nx = snl.shape
    msno = -snl   # 0..5

    # gather into compressed top-down arrays: comp[k-1] = stack[j=k+snl]
    k_ax = jnp.arange(1, NLEVSNOW + 1, dtype=jnp.int32)[:, None, None]
    gidx = k_ax + snl[None] + (NLEVSNOW - 1)   # stack m for rank k
    def gath(a):
        return jnp.take_along_axis(a, jnp.clip(gidx, 0, NSOISNO - 1), axis=0)
    dzsno, swice, swliq, tsno = (gath(dz), gath(h2osoi_ice),
                                 gath(h2osoi_liq), gath(t_soisno))

    # msno == 1 and dz1 > 0.03 -> split into 2 (:4167-4178)
    c = (msno == 1) & (dzsno[0] > 0.03)
    half = 0.5 * dzsno[0]
    dzsno = dzsno.at[0].set(jnp.where(c, half, dzsno[0]))
    dzsno = dzsno.at[1].set(jnp.where(c, half, dzsno[1]))
    swice = swice.at[1].set(jnp.where(c, 0.5 * swice[0], swice[1]))
    swice = swice.at[0].set(jnp.where(c, 0.5 * swice[0], swice[0]))
    swliq = swliq.at[1].set(jnp.where(c, 0.5 * swliq[0], swliq[1]))
    swliq = swliq.at[0].set(jnp.where(c, 0.5 * swliq[0], swliq[0]))
    tsno = tsno.at[1].set(jnp.where(c, tsno[0], tsno[1]))
    msno = jnp.where(c, 2, msno)

    def shave(msno, dzsno, swice, swliq, tsno, k, maxdz, split_thresh,
              split_if_msno_le):
        """Trim rank k to maxdz, Combo the excess into rank k+1, then
        split rank k+1 if it grew beyond split_thresh (:4180-4268)."""
        c1 = (msno > k + 1) & (dzsno[k] > maxdz)
        drr = dzsno[k] - maxdz
        propor = drr / jnp.maximum(dzsno[k], 1e-12)
        zwice = propor * swice[k]
        zwliq = propor * swliq[k]
        keep = maxdz / jnp.maximum(dzsno[k], 1e-12)
        swice_k = keep * swice[k]
        swliq_k = keep * swliq[k]
        dzc, liqc, icec, tc = combo(
            dzsno[k + 1], swliq[k + 1], swice[k + 1], tsno[k + 1],
            drr, zwliq, zwice, tsno[k])
        dzsno = dzsno.at[k].set(jnp.where(c1, maxdz, dzsno[k]))
        swice = swice.at[k].set(jnp.where(c1, swice_k, swice[k]))
        swliq = swliq.at[k].set(jnp.where(c1, swliq_k, swliq[k]))
        dzsno = dzsno.at[k + 1].set(jnp.where(c1, dzc, dzsno[k + 1]))
        swice = swice.at[k + 1].set(jnp.where(c1, icec, swice[k + 1]))
        swliq = swliq.at[k + 1].set(jnp.where(c1, liqc, swliq[k + 1]))
        tsno = tsno.at[k + 1].set(jnp.where(c1, tc, tsno[k + 1]))
        if split_thresh is not None:
            c2 = c1 & (msno <= split_if_msno_le) \
                & (dzsno[k + 1] > split_thresh)
            half = 0.5 * dzsno[k + 1]
            dzsno = dzsno.at[k + 2].set(jnp.where(c2, half, dzsno[k + 2]))
            swice = swice.at[k + 2].set(
                jnp.where(c2, 0.5 * swice[k + 1], swice[k + 2]))
            swliq = swliq.at[k + 2].set(
                jnp.where(c2, 0.5 * swliq[k + 1], swliq[k + 2]))
            tsno = tsno.at[k + 2].set(jnp.where(c2, tsno[k + 1], tsno[k + 2]))
            dzsno = dzsno.at[k + 1].set(jnp.where(c2, half, dzsno[k + 1]))
            swice = swice.at[k + 1].set(
                jnp.where(c2, 0.5 * swice[k + 1], swice[k + 1]))
            swliq = swliq.at[k + 1].set(
                jnp.where(c2, 0.5 * swliq[k + 1], swliq[k + 1]))
            msno = jnp.where(c2, k + 3, msno)
        return msno, dzsno, swice, swliq, tsno

    msno, dzsno, swice, swliq, tsno = shave(
        msno, dzsno, swice, swliq, tsno, 0, 0.02, 0.07, 2)
    msno, dzsno, swice, swliq, tsno = shave(
        msno, dzsno, swice, swliq, tsno, 1, 0.05, 0.18, 3)
    msno, dzsno, swice, swliq, tsno = shave(
        msno, dzsno, swice, swliq, tsno, 2, 0.11, 0.41, 4)
    msno, dzsno, swice, swliq, tsno = shave(
        msno, dzsno, swice, swliq, tsno, 3, 0.23, None, None)

    snl = -msno

    # scatter back: stack[j] = comp[j - snl - 1] for active layers
    m_ax = jnp.arange(NSOISNO, dtype=jnp.int32)[:, None, None]
    j_ax = m_ax - (NLEVSNOW - 1)
    cidx = jnp.clip(j_ax - snl[None] - 1, 0, NLEVSNOW - 1)
    smask = _snow_mask(snl)
    def scat(stack, comp):
        gathered = jnp.take_along_axis(comp, cidx, axis=0)
        return jnp.where(smask, gathered, stack)
    dz = scat(dz, dzsno)
    h2osoi_ice = scat(h2osoi_ice, swice)
    h2osoi_liq = scat(h2osoi_liq, swliq)
    t_soisno = scat(t_soisno, tsno)

    z, zi = _rebuild_snow_geometry(snl, dz, z, zi)
    return snl, dz, zi, t_soisno, h2osoi_ice, h2osoi_liq, z


def shal_lake_hydrology(dz_lake, forc_rain, forc_snow, qflx_evap_tot,
                        forc_t, t_grnd, qflx_evap_soi, qflx_snomelt, imelt,
                        frac_iceold, z, dz, zi, snl, h2osno, snowdp,
                        lake_icefrac, t_lake, t_soisno, h2osoi_ice,
                        h2osoi_liq, h2osoi_vol, watsat, dtime):
    """Snow-layer hydrology over the lake (ShalLakeHydrology,
    water_lake.f90:2562-3325): snowfall accumulation & layer initiation,
    sublimation/dew, percolation, compaction, combine/divide, the
    snow-over-unfrozen-lake dump, and the saturated-soil bookkeeping.
    do_capsnow = .false. as in the ICAR driver."""
    ny, nx = snl.shape

    # precipitation onto ground (:2756-2797)
    qflx_prec_grnd_snow = forc_snow
    qflx_prec_grnd_rain = forc_rain
    qflx_prec_grnd = qflx_prec_grnd_snow + qflx_prec_grnd_rain
    qflx_snow_grnd = qflx_prec_grnd_snow
    qflx_rain_grnd = qflx_prec_grnd_rain

    # snowfall accumulation; Alta density relationship (:2804-2825)
    bifall = jnp.where(
        forc_t > TFRZ + 2.0, 50.0 + 1.7 * 17.0 ** 1.5,
        jnp.where(forc_t > TFRZ - 15.0,
                  50.0 + 1.7 * jnp.maximum(forc_t - TFRZ + 15.0, 0.0) ** 1.5,
                  50.0))
    dz_snowf = qflx_snow_grnd / bifall
    snowdp = snowdp + dz_snowf * dtime
    h2osno = h2osno + qflx_snow_grnd * dtime

    # new snow-layer initiation (:2834-2846)
    newnode = (snl == 0) & (qflx_snow_grnd > 0.0) & (snowdp >= 0.01)
    m0 = NLEVSNOW - 1    # stack index of j = 0
    snl = jnp.where(newnode, -1, snl)
    dz = dz.at[m0].set(jnp.where(newnode, snowdp, dz[m0]))
    z = z.at[m0].set(jnp.where(newnode, -0.5 * snowdp, z[m0]))
    zi = zi.at[m0].set(jnp.where(newnode, -snowdp, zi[m0]))
    t_soisno = t_soisno.at[m0].set(
        jnp.where(newnode, jnp.minimum(TFRZ, forc_t), t_soisno[m0]))
    h2osoi_ice = h2osoi_ice.at[m0].set(
        jnp.where(newnode, h2osno, h2osoi_ice[m0]))
    h2osoi_liq = h2osoi_liq.at[m0].set(
        jnp.where(newnode, 0.0, h2osoi_liq[m0]))
    frac_iceold = frac_iceold.at[m0].set(
        jnp.where(newnode, 1.0, frac_iceold[m0]))

    # accretion onto existing top layer (:2852-2855)
    accrete = (snl < 0) & ~newnode
    jtop_m = snl + NLEVSNOW
    ice_top = _gather_m(h2osoi_ice, jtop_m)
    dz_top = _gather_m(dz, jtop_m)
    h2osoi_ice = _scatter_m(h2osoi_ice, jtop_m,
                            ice_top + dtime * qflx_snow_grnd, accrete)
    dz = _scatter_m(dz, jtop_m, dz_top + dz_snowf * dtime, accrete)

    # sublimation / dew partition (:2861-2941)
    has_layers = snl < 0
    liq_top = _gather_m(h2osoi_liq, jtop_m)
    ice_top = _gather_m(h2osoi_ice, jtop_m)
    tot_top = liq_top + ice_top
    evap_pos = qflx_evap_soi >= 0.0
    # with snow layers:
    evap_lim = jnp.minimum(qflx_evap_soi, tot_top / dtime)
    qflx_evap_grnd_l = jnp.where(
        tot_top > 0.0,
        jnp.maximum(evap_lim * liq_top / jnp.maximum(tot_top, 1e-12), 0.0),
        0.0)
    qflx_sub_snow_l = evap_lim - qflx_evap_grnd_l
    qflx_dew_snow_l = jnp.where(t_grnd < TFRZ, jnp.abs(qflx_evap_soi), 0.0)
    qflx_dew_grnd_l = jnp.where(t_grnd >= TFRZ, jnp.abs(qflx_evap_soi), 0.0)
    # without snow layers:
    qflx_sub_snow_n = jnp.minimum(qflx_evap_soi, h2osno / dtime)
    qflx_evap_grnd_n = qflx_evap_soi - qflx_sub_snow_n
    qflx_dew_snow_n = jnp.where(t_grnd < TFRZ - 0.1,
                                jnp.abs(qflx_evap_soi), 0.0)
    qflx_dew_grnd_n = jnp.where(t_grnd >= TFRZ - 0.1,
                                jnp.abs(qflx_evap_soi), 0.0)

    qflx_evap_grnd = jnp.where(
        evap_pos, jnp.where(has_layers, qflx_evap_grnd_l, qflx_evap_grnd_n),
        0.0)
    qflx_sub_snow = jnp.where(
        evap_pos, jnp.where(has_layers, qflx_sub_snow_l, qflx_sub_snow_n),
        0.0)
    qflx_dew_snow = jnp.where(
        ~evap_pos, jnp.where(has_layers, qflx_dew_snow_l, qflx_dew_snow_n),
        0.0)
    qflx_dew_grnd = jnp.where(
        ~evap_pos, jnp.where(has_layers, qflx_dew_grnd_l, qflx_dew_grnd_n),
        0.0)

    # no snow layers: update bulk pack for dew & sublimation (:2922-2938)
    h2osno_temp = h2osno
    h2osno_n = h2osno + (-qflx_sub_snow + qflx_dew_snow) * dtime
    snowdp_n = jnp.where(h2osno_temp > 0.0,
                         snowdp * h2osno_n / jnp.maximum(h2osno_temp, 1e-12),
                         h2osno_n / 250.0)
    h2osno = jnp.where(has_layers, h2osno, jnp.maximum(h2osno_n, 0.0))
    snowdp = jnp.where(has_layers, snowdp, snowdp_n)

    # snow water / percolation
    h2osoi_ice, h2osoi_liq, qflx_top_soil = snow_water(
        snl, qflx_snomelt, qflx_rain_grnd, qflx_sub_snow, qflx_evap_grnd,
        qflx_dew_snow, qflx_dew_grnd, dz, h2osoi_ice, h2osoi_liq, dtime)

    # keep lake-bed soil saturated (:2970-2984)
    liq_soil = h2osoi_liq[NLEVSNOW:]
    ice_soil = h2osoi_ice[NLEVSNOW:]
    vol_soil = h2osoi_vol[NLEVSNOW:]
    dz_soil = dz[NLEVSNOW:]
    liq_sat = (watsat * dz_soil - ice_soil / DENICE) * DENH2O
    liq_cap = watsat * DENH2O * dz_soil
    liq_soil = jnp.where(vol_soil < watsat, liq_sat,
                         jnp.minimum(liq_soil, liq_cap))
    h2osoi_liq = h2osoi_liq.at[NLEVSNOW:].set(liq_soil)

    # compaction / combine / divide
    dz = snow_compaction(snl, imelt, frac_iceold, t_soisno, h2osoi_ice,
                         h2osoi_liq, dz, dtime)
    (snl, h2osno, snowdp, dz, zi, t_soisno, h2osoi_ice, h2osoi_liq, z) = \
        combine_snow_layers(snl, h2osno, snowdp, dz, zi, t_soisno,
                            h2osoi_ice, h2osoi_liq, z)
    (snl, dz, zi, t_soisno, h2osoi_ice, h2osoi_liq, z) = \
        divide_snow_layers(snl, dz, zi, t_soisno, h2osoi_ice, h2osoi_liq, z)

    # snow layers above an unfrozen lake fall in and melt (:3032-3097)
    smask = _snow_mask(snl)
    unfrozen = (t_lake[0] > TFRZ) & (lake_icefrac[0] == 0.0) & (snl < 0)
    sumsnowice = jnp.sum(jnp.where(smask, h2osoi_ice, 0.0), axis=0)
    heatsum = jnp.sum(
        jnp.where(smask,
                  h2osoi_ice * CPICE * (TFRZ - t_soisno)
                  + h2osoi_liq * CPLIQ * (TFRZ - t_soisno), 0.0), axis=0)
    heatsum = heatsum + sumsnowice * HFUS
    heatrem = ((t_lake[0] - TFRZ) * CPLIQ * DENH2O * dz_lake[0] - heatsum)
    dump = unfrozen & (heatrem + DENH2O * dz_lake[0] * HFUS > 0.0)
    h2osno = jnp.where(dump, 0.0, h2osno)
    snl = jnp.where(dump, 0, snl)
    t_lake0_cool = t_lake[0] - heatrem / (CPLIQ * DENH2O * dz_lake[0])
    icef0_frz = -heatrem / (DENH2O * dz_lake[0] * HFUS)
    t_lake = t_lake.at[0].set(
        jnp.where(dump, jnp.where(heatrem > 0.0, t_lake0_cool, TFRZ),
                  t_lake[0]))
    lake_icefrac = lake_icefrac.at[0].set(
        jnp.where(dump & (heatrem <= 0.0), icef0_frz, lake_icefrac[0]))

    # zero out layers no longer in use (:3114-3130); snowdp bookkeeping
    smask = _snow_mask(snl)
    m_ax = jnp.arange(NSOISNO, dtype=jnp.int32)[:, None, None]
    is_snow_slot = (m_ax - (NLEVSNOW - 1)) <= 0
    dead = is_snow_slot & ~smask
    h2osoi_ice = jnp.where(dead, 0.0, h2osoi_ice)
    h2osoi_liq = jnp.where(dead, 0.0, h2osoi_liq)
    t_soisno = jnp.where(dead, 0.0, t_soisno)
    dz = jnp.where(dead, 0.0, dz)
    z = jnp.where(dead, 0.0, z)
    zi = zi.at[:NLEVSNOW].set(
        jnp.where(dead[:NLEVSNOW], 0.0, zi[:NLEVSNOW]))
    # NOTE reference quirk preserved: snowdp is NOT reset when the snow
    # stack dumps into an unfrozen lake (water_lake.f90:3081-3084); the
    # stale value self-corrects in the next step's no-layer dew branch.

    # volumetric soil water (:3178-3186)
    h2osoi_vol = h2osoi_vol.at[NLEVSNOW:].set(
        h2osoi_liq[NLEVSNOW:] / (dz[NLEVSNOW:] * DENH2O)
        + h2osoi_ice[NLEVSNOW:] / (dz[NLEVSNOW:] * DENICE))

    return dict(z=z, dz=dz, zi=zi, snl=snl, h2osno=h2osno, snowdp=snowdp,
                lake_icefrac=lake_icefrac, t_lake=t_lake, t_soisno=t_soisno,
                h2osoi_ice=h2osoi_ice, h2osoi_liq=h2osoi_liq,
                h2osoi_vol=h2osoi_vol, qflx_prec_grnd=qflx_prec_grnd)


def lake_main(forc_t, forc_pbot, forc_psrf, forc_hgt, forc_q, forc_u,
              forc_v, forc_lwrad, prec, sabg, lat_rad, z_lake, dz_lake,
              lakedepth, h2osno, snowdp, snl, z, dz, zi, h2osoi_vol,
              h2osoi_liq, h2osoi_ice, t_grnd, t_soisno, t_lake, savedtke1,
              lake_icefrac, watsat, tkmg, tkdry, tksatu, csol, dtime):
    """One lake timestep: fluxes -> temperature -> hydrology (LakeMain,
    water_lake.f90:444-629). Returns (outputs dict, new state dict)."""
    # rain/snow partition at tcrit (:590-610)
    is_snow = forc_t <= TFRZ + TCRIT
    forc_rain = jnp.where(is_snow, 0.0, prec)
    forc_snow = jnp.where(is_snow, prec, 0.0)

    fx = shal_lake_fluxes(
        forc_t, forc_pbot, forc_psrf, forc_hgt, forc_q, forc_u, forc_v,
        forc_lwrad, sabg, lat_rad, dz, dz_lake, t_soisno, t_lake, snl,
        h2osoi_liq, h2osoi_ice, savedtke1, t_grnd, h2osno)

    tout = shal_lake_temperature(
        fx.t_grnd, h2osno, sabg, dz, dz_lake, z, zi, z_lake, fx.ws, fx.ks,
        snl, fx.eflx_gnet, lakedepth, lake_icefrac, snowdp, t_lake,
        t_soisno, h2osoi_liq, h2osoi_ice, watsat, tkmg, tkdry, tksatu,
        csol, fx.eflx_sh_grnd, fx.eflx_sh_tot, fx.eflx_soil_grnd, dtime)

    hout = shal_lake_hydrology(
        dz_lake, forc_rain, forc_snow, fx.qflx_evap_soi, forc_t, fx.t_grnd,
        fx.qflx_evap_soi, tout["qflx_snomelt"], tout["imelt"],
        tout["frac_iceold"], z, dz, zi, snl, tout["h2osno"],
        tout["snowdp"], tout["lake_icefrac"], tout["t_lake"],
        tout["t_soisno"], tout["h2osoi_ice"], tout["h2osoi_liq"],
        h2osoi_vol, watsat, dtime)

    outputs = dict(
        eflx_sh_tot=tout["eflx_sh_tot"], eflx_lh_tot=fx.eflx_lh_tot,
        eflx_gnet=tout["eflx_gnet"], t_grnd=fx.t_grnd,
        t_ref2m=fx.t_ref2m, q_ref2m=fx.q_ref2m,
        qflx_evap_soi=fx.qflx_evap_soi, htvp=fx.htvp)
    state = dict(
        savedtke1=tout["savedtke1"], snowdp=hout["snowdp"],
        h2osno=hout["h2osno"], snl=hout["snl"], t_grnd=fx.t_grnd,
        t_lake=hout["t_lake"], lake_icefrac=hout["lake_icefrac"],
        z=hout["z"], dz=hout["dz"], zi=hout["zi"],
        t_soisno=hout["t_soisno"], h2osoi_liq=hout["h2osoi_liq"],
        h2osoi_ice=hout["h2osoi_ice"], h2osoi_vol=hout["h2osoi_vol"])
    return outputs, state


def lake_driver(s, t_1, p_if0, p_if1, dz8w_1, qv_1, u_1, v_1, glw, swdown,
                prec_mm, lat_deg, dtime):
    """Grid-level lake step (Lake, water_lake.f90:139-441).

    ``s`` carries the lake state fields from the model state dict (names as
    in the registry); forcing arguments are the lowest-model-level fields.
    Returns (outputs, new_state_fields) — the caller applies them under
    ``lakemask``.
    """
    q2k = qv_1 / (1.0 + qv_1)                # mixing ratio -> spec. humidity
    emissi = s["emissivity"]
    lwdn = glw * emissi
    prec_rate = prec_mm / dtime              # mm -> mm/s
    solnet = swdown * (1.0 - s["albedo"])
    zlvl = 0.5 * dz8w_1
    lat_rad = lat_deg * (np.pi / 180.0)

    snl = -jnp.abs(s["snl2d"]).astype(jnp.int32)   # stored as float field

    outputs, new = lake_main(
        forc_t=t_1, forc_pbot=p_if1, forc_psrf=p_if0, forc_hgt=zlvl,
        forc_q=q2k, forc_u=u_1, forc_v=v_1, forc_lwrad=lwdn,
        prec=prec_rate, sabg=solnet, lat_rad=lat_rad,
        z_lake=s["z_lake3d"], dz_lake=s["dz_lake3d"],
        lakedepth=s["lakedepth2d"], h2osno=s["swe"].astype(jnp.float32),
        snowdp=s["snow_height"], snl=snl,
        z=s["z3d"], dz=s["dz3d"], zi=s["zi3d"],
        h2osoi_vol=s["h2osoi_vol3d"], h2osoi_liq=s["h2osoi_liq3d"],
        h2osoi_ice=s["h2osoi_ice3d"], t_grnd=s["t_grnd2d"],
        t_soisno=s["t_soisno3d"], t_lake=s["t_lake3d"],
        savedtke1=s["savedtke12d"], lake_icefrac=s["lake_icefrac3d"],
        watsat=s["watsat3d"], tkmg=s["tkmg3d"], tkdry=s["tkdry3d"],
        tksatu=s["tksatu3d"], csol=s["csol3d"], dtime=dtime)

    tsk = outputs["t_grnd"]
    qfx = outputs["eflx_lh_tot"] / jnp.where(tsk >= TFRZ, HVAP, HSUB)
    albedo = (0.6 * new["lake_icefrac"][0]
              + (1.0 - new["lake_icefrac"][0]) * 0.08)
    th2 = outputs["t_ref2m"] * (1.0e5 / p_if0) ** (RAIR / CPAIR)

    out = dict(hfx=outputs["eflx_sh_tot"], lh=outputs["eflx_lh_tot"],
               grdflx=outputs["eflx_gnet"], tsk=tsk, qfx=qfx,
               t2=outputs["t_ref2m"], th2=th2, q2=outputs["q_ref2m"],
               albedo=albedo)
    fields = dict(
        savedtke12d=new["savedtke1"], snow_height=new["snowdp"],
        swe=new["h2osno"], snl2d=new["snl"].astype(jnp.float32),
        t_grnd2d=new["t_grnd"], t_lake3d=new["t_lake"],
        lake_icefrac3d=new["lake_icefrac"], z3d=new["z"], dz3d=new["dz"],
        zi3d=new["zi"], t_soisno3d=new["t_soisno"],
        h2osoi_liq3d=new["h2osoi_liq"], h2osoi_ice3d=new["h2osoi_ice"],
        h2osoi_vol3d=new["h2osoi_vol"])
    return out, fields


# --------------------------------------------------------------------------
# host-side initialization (lakeini, water_lake.f90:4904-5431)
# --------------------------------------------------------------------------

def lake_init(fields: Dict[str, np.ndarray], terrain: np.ndarray,
              lat: np.ndarray, lake_category: int = 21,
              water_category: int = 17,
              lakedepth_default: float = 50.0,
              lake_min_elev: float = 5.0) -> None:
    """Initialize the lake state in-place on host numpy arrays (lakeini).

    Mirrors the ICAR driver's call (lsm_driver.f90:948-989): lakemask from
    the land-use lake category when available (lakeflag=1), otherwise from
    water cells above lake_min_elev; lake depth from the hi-res
    ``lake_depth`` field when present, else lakedepth_default.
    """
    veg = fields["veg_type"]
    tsk = fields["skin_temperature"]
    ny, nx = terrain.shape

    if lake_category != -1:
        # lakeflag = 1: land-use data provides a lake category (:5062-5076)
        lakemask = (veg == lake_category)
    else:
        # lakeflag = 0: guess lakes = water cells above lake_min_elev
        lakemask = (veg == water_category) & (terrain >= lake_min_elev)
    fields["lakemask"] = lakemask.astype(np.float32)

    snow = np.asarray(fields["swe"], np.float64)
    snowdp = snow * 0.005                       # kg/m2 -> m (:5009)
    fields["snow_height"] = np.where(lakemask, snowdp,
                                     fields["snow_height"]).astype(np.float32)

    lake_depth = fields.get("lake_depth")
    if lake_depth is not None and np.any(lake_depth > 0):
        depth = np.where(lake_depth > 0, lake_depth, lakedepth_default)
    else:
        depth = np.full((ny, nx), lakedepth_default, np.float32)
    # non-lake cells keep a benign default depth so the masked grid math
    # stays finite (their results are never applied)
    fields["lakedepth2d"] = np.where(lakemask, depth,
                                     lakedepth_default).astype(np.float32)

    # lake layer grid: 10 uniform fractional layers (:5168-5189, the
    # ICAR/BK revision) scaled by depth via depthratio
    dzlak = np.full(NLEVLAKE, 0.1)
    zlak = 0.05 + 0.1 * np.arange(NLEVLAKE)
    std_depth = zlak[-1] + 0.5 * dzlak[-1]      # = 1.0
    depthratio = fields["lakedepth2d"] / std_depth
    dz_lake = dzlak[:, None, None] * depthratio[None]
    z_lake = np.empty_like(dz_lake)
    z_lake[0] = zlak[0]
    dz_lake[0] = dzlak[0]
    z_lake[1:] = (zlak[1:, None, None] * depthratio[None]
                  + dzlak[0] * (1.0 - depthratio[None]))
    fields["z_lake3d"] = z_lake.astype(np.float32)
    fields["dz_lake3d"] = dz_lake.astype(np.float32)

    # soil node grid (:5193-5209)
    scalez = 0.025
    js = np.arange(1, NLEVSOIL + 1)
    zsoi = scalez * (np.exp(0.5 * (js - 0.5)) - 1.0)
    dzsoi = np.empty(NLEVSOIL)
    dzsoi[0] = 0.5 * (zsoi[0] + zsoi[1])
    dzsoi[1:-1] = 0.5 * (zsoi[2:] - zsoi[:-2])
    dzsoi[-1] = zsoi[-1] - zsoi[-2]
    zisoi = np.empty(NLEVSOIL + 1)
    zisoi[0] = 0.0
    zisoi[1:-1] = 0.5 * (zsoi[:-1] + zsoi[1:])
    zisoi[-1] = zsoi[-1] + 0.5 * dzsoi[-1]

    # soil hydraulic/thermal properties from texture (:5219-5240)
    isl = np.clip(fields["soil_type"].astype(np.int32), 1, 19)
    isl = np.where(isl == 14, 15, isl)
    sand = SAND[isl - 1]
    clay = CLAY[isl - 1]
    watsat = 0.489 - 0.00126 * sand
    bd = (1.0 - watsat) * 2.7e3
    tkm = (8.80 * sand + 2.92 * clay) / (sand + clay)
    tkmg = tkm ** (1.0 - watsat)
    tksatu = tkmg * 0.57 ** watsat
    tkdry = (0.135 * bd + 64.7) / (2.7e3 - 0.947 * bd)
    csol = (2.128 * sand + 2.385 * clay) / (sand + clay) * 1.0e6
    for name, arr in (("watsat3d", watsat), ("tkmg3d", tkmg),
                      ("tksatu3d", tksatu), ("tkdry3d", tkdry),
                      ("csol3d", csol)):
        fields[name] = np.broadcast_to(
            arr[None], (NLEVSOIL, ny, nx)).astype(np.float32).copy()

    # initial temperatures (:5243-5272)
    t_lake = np.where(z_lake <= DEPTH_C,
                      tsk[None] + (277.0 - tsk[None]) / DEPTH_C * z_lake,
                      277.0)
    t_lake[0] = tsk
    fields["t_lake3d"] = t_lake.astype(np.float32)
    fields["t_grnd2d"] = np.full((ny, nx), 277.0, np.float32)

    t_soisno = np.zeros((NSOISNO, ny, nx), np.float32)
    t_soisno[NLEVSNOW] = tsk
    for k in range(1, NLEVSOIL):
        zl = z_lake[min(k, NLEVLAKE - 1)]
        t_soisno[NLEVSNOW + k] = np.where(
            zl <= DEPTH_C, tsk + (277.0 - tsk) / DEPTH_C * zl, 277.0)

    # soil/snow node geometry
    z3d = np.zeros((NSOISNO, ny, nx), np.float32)
    dz3d = np.zeros((NSOISNO, ny, nx), np.float32)
    zi3d = np.zeros((NSOISNO + 1, ny, nx), np.float32)
    z3d[NLEVSNOW:] = zsoi[:, None, None]
    dz3d[NLEVSNOW:] = dzsoi[:, None, None]
    zi3d[NLEVSNOW:] = zisoi[:, None, None]

    # snow layer structure from snow depth (:5297-5352)
    sd = snowdp
    snl = np.zeros((ny, nx), np.int32)
    # dz assignment per snow-depth band (lakeini's explicit cascade)
    def setdz(mask, vals):
        for j, v in vals.items():
            m = j + NLEVSNOW - 1
            dz3d[m] = np.where(mask, v, dz3d[m])
    sd64 = sd
    m0 = (sd >= 0.01) & (sd <= 0.03)
    setdz(m0, {0: sd64})
    snl = np.where(m0, -1, snl)
    m1 = (sd > 0.03) & (sd <= 0.04)
    setdz(m1, {-1: sd64 / 2.0, 0: sd64 / 2.0})
    snl = np.where(m1, -2, snl)
    m2 = (sd > 0.04) & (sd <= 0.07)
    setdz(m2, {-1: 0.02, 0: sd64 - 0.02})
    snl = np.where(m2, -2, snl)
    m3 = (sd > 0.07) & (sd <= 0.12)
    setdz(m3, {-2: 0.02, -1: (sd64 - 0.02) / 2.0, 0: (sd64 - 0.02) / 2.0})
    snl = np.where(m3, -3, snl)
    m4 = (sd > 0.12) & (sd <= 0.18)
    setdz(m4, {-2: 0.02, -1: 0.05, 0: sd64 - 0.07})
    snl = np.where(m4, -3, snl)
    m5 = (sd > 0.18) & (sd <= 0.29)
    setdz(m5, {-3: 0.02, -2: 0.05, -1: (sd64 - 0.07) / 2.0,
               0: (sd64 - 0.07) / 2.0})
    snl = np.where(m5, -4, snl)
    m6 = (sd > 0.29) & (sd <= 0.41)
    setdz(m6, {-3: 0.02, -2: 0.05, -1: 0.11, 0: sd64 - 0.18})
    snl = np.where(m6, -4, snl)
    m7 = (sd > 0.41) & (sd <= 0.64)
    setdz(m7, {-4: 0.02, -3: 0.05, -2: 0.11, -1: (sd64 - 0.18) / 2.0,
               0: (sd64 - 0.18) / 2.0})
    snl = np.where(m7, -5, snl)
    m8 = sd > 0.64
    setdz(m8, {-4: 0.02, -3: 0.05, -2: 0.11, -1: 0.23, 0: sd64 - 0.41})
    snl = np.where(m8, -5, snl)

    # snow node z/zi downward from the surface (:5355-5358)
    for j in range(0, -NLEVSNOW, -1):
        m = j + NLEVSNOW - 1
        active = snl <= j - 1
        z3d[m] = np.where(active, zi3d[m + 1] - 0.5 * dz3d[m], z3d[m])
        zi3d[m] = np.where(active, zi3d[m + 1] - dz3d[m], zi3d[m])

    # arbitrary initial snow/soil temperatures and water (:5363-5420)
    for j in range(-NLEVSNOW + 1, 1):
        m = j + NLEVSNOW - 1
        t_soisno[m] = np.where(snl <= j - 1, 250.0, t_soisno[m])
    lake_icefrac = np.where(t_lake >= TFRZ, 0.0, 1.0)
    fields["lake_icefrac3d"] = lake_icefrac.astype(np.float32)

    h2osoi_vol = np.zeros((NSOISNO, ny, nx), np.float32)
    h2osoi_vol[NLEVSNOW:] = np.minimum(1.0, watsat[None])
    h2osoi_ice = np.zeros((NSOISNO, ny, nx), np.float32)
    h2osoi_liq = np.zeros((NSOISNO, ny, nx), np.float32)
    soil_frozen = t_soisno[NLEVSNOW:] <= TFRZ
    h2osoi_ice[NLEVSNOW:] = np.where(
        soil_frozen, dz3d[NLEVSNOW:] * DENICE * h2osoi_vol[NLEVSNOW:], 0.0)
    h2osoi_liq[NLEVSNOW:] = np.where(
        soil_frozen, 0.0, dz3d[NLEVSNOW:] * DENH2O * h2osoi_vol[NLEVSNOW:])
    for j in range(-NLEVSNOW + 1, 1):
        m = j + NLEVSNOW - 1
        active = snl <= j - 1     # k > snl in reference == j >= snl+1
        h2osoi_ice[m] = np.where(active, dz3d[m] * BDSNO, h2osoi_ice[m])
        h2osoi_liq[m] = np.where(active, 0.0, h2osoi_liq[m])

    fields["t_soisno3d"] = t_soisno
    fields["h2osoi_ice3d"] = h2osoi_ice
    fields["h2osoi_liq3d"] = h2osoi_liq
    fields["h2osoi_vol3d"] = h2osoi_vol
    fields["z3d"] = z3d
    fields["dz3d"] = dz3d
    fields["zi3d"] = zi3d
    fields["snl2d"] = snl.astype(np.float32)
    fields["savedtke12d"] = np.full((ny, nx), TKWAT, np.float32)
