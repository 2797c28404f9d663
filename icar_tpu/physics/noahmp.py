"""NoahMP land-surface model (lsm=4), a JAX rewrite.

Re-implementation of MODULE_SF_NOAHMPLSM
(/root/reference/src/physics/lsm_noahmplsm.f90, ~11k lines of per-column
Fortran) for the fixed option set ICAR hardwires
(lsm_driver.f90:773-793): dveg=1 (table LAI, FVEG=SHDFAC), Ball-Berry
stomata, Noah beta, SIMGM runoff/groundwater, M-O surface exchange
(SFCDIF1), NY06 supercooled water & frozen-soil permeability, iopt_rad=1
canopy gaps, BATS snow albedo, Jordan91 rain/snow partition, Noah TBOT,
semi-implicit snow/soil temperature.  Crop, irrigation, urban and dynamic
vegetation/carbon are disabled in ICAR (iopt_crop=0, iopt_irr=0,
sf_urban_physics=0, dveg=1) and are not ported.

Architecture: the reference runs one scalar column at a time; here each
routine is masked array math over (y, x) grids with the snow/soil stack on
axis 0 (3 snow + 4 soil = 7 layers; stack index m = j + NSNOW - 1 for CLM
index j in [-2..4]).  The reference's iterative flux solvers (VEGE_FLUX
NITERC=20/NITERG=5 Newton loops with embedded Monin-Obukhov updates,
BARE_FLUX NITERB=5) become fixed-trip-count loops of vectorized updates;
its per-column EXITs become where-masks.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from ..ops.indexing import take_level
import numpy as np

from .noahmp_params import NSOIL, NSNOW

NSS = NSNOW + NSOIL          # 7-layer snow+soil stack

# module constants (lsm_noahmplsm.f90:192-208)
GRAV = 9.80616
SB = 5.67e-8
VKC = 0.40
TFRZ = 273.16
HSUB = 2.8440e6
HVAP = 2.5104e6
HFUS = 0.3336e6
CWAT = 4.188e6
CICE = 2.094e6
CPAIR = 1004.64
TKWAT = 0.6
TKICE = 2.2
TKAIR = 0.023
RAIR = 287.04
RW = 461.269
DENH2O = 1000.0
DENICE = 917.0

MPE = 1e-6    # prevents division by zero (used throughout the reference)


def _stack_j():
    """CLM layer index j = m - NSNOW + 1 for stack axis m in [0..NSS-1]:
    j in [-2..0] snow, [1..4] soil."""
    return (jnp.arange(NSS, dtype=jnp.int32) - (NSNOW - 1))[:, None, None]


def _active(isnow):
    """(NSS, ny, nx) mask of layers in use (j >= isnow+1)."""
    return _stack_j() >= isnow[None] + 1


def _snow_mask(isnow):
    j = _stack_j()
    return (j >= isnow[None] + 1) & (j <= 0)


def _gather_m(arr, midx):
    return take_level(arr, midx.astype(jnp.int32))


def _scatter_m(arr, midx, val, do):
    L = arr.shape[0]
    lay = jnp.arange(L, dtype=jnp.int32)[:, None, None]
    hit = (lay == midx[None].astype(jnp.int32)) & do[None]
    return jnp.where(hit, val[None], arr)


# ==========================================================================
# forcing pre-processing (ATM, lsm_noahmplsm.f90:1025-1199)
# ==========================================================================

def atm(p, sfcprs, sfctmp, q2, prcp, soldn, cosz):
    """Re-process atmospheric forcing. OPT_SNF=1 (Jordan 1991) rain/snow
    partition; ICAR passes total precip only (prcpconv=0)."""
    thair = sfctmp      # PAIR == SFCPRS in the reference (jref comment)
    qair = q2
    eair = qair * sfcprs / (0.622 + 0.378 * qair)
    rhoair = (sfcprs - 0.378 * eair) / (RAIR * sfctmp)
    swdown = jnp.where(cosz <= 0.0, 0.0, soldn)
    solad = jnp.stack([swdown * 0.35, swdown * 0.35])   # direct vis/nir
    solai = jnp.stack([swdown * 0.15, swdown * 0.15])   # diffuse vis/nir
    qprecc = 0.10 * prcp
    qprecl = 0.90 * prcp
    fp = jnp.where(qprecc + qprecl > 0.0,
                   (qprecc + qprecl) / (10.0 * qprecc + qprecl + MPE), 0.0)
    # Jordan (1991) partition
    fpice = jnp.where(
        sfctmp > TFRZ + 2.5, 0.0,
        jnp.where(sfctmp <= TFRZ + 0.5, 1.0,
                  jnp.where(sfctmp <= TFRZ + 2.0,
                            1.0 - (-54.632 + 0.2 * sfctmp), 0.6)))
    # Hedstrom & Pomeroy (1998) fresh snow density
    bdfall = jnp.minimum(120.0, 67.92 + 51.25
                         * jnp.exp((sfctmp - TFRZ) / 2.59))
    rain = prcp * (1.0 - fpice)
    snow = prcp * fpice
    return SimpleNamespace(thair=thair, qair=qair, eair=eair, rhoair=rhoair,
                           swdown=swdown, solad=solad, solai=solai,
                           qprecc=qprecc, qprecl=qprecl, fp=fp, fpice=fpice,
                           bdfall=bdfall, rain=rain, snow=snow, prcp=prcp)


# ==========================================================================
# vegetation phenology (PHENOLOGY, :1201-1307)
# ==========================================================================

def phenology(p, vegtype, snowh, tv, lat, yearlen, julian):
    """Monthly-table LAI/SAI (dveg=1) + burial by snow. Returns
    (lai, sai, elai, esai, igs)."""
    day = jnp.where(lat >= 0.0, julian,
                    jnp.mod(julian + 0.5 * yearlen, yearlen))
    t = 12.0 * day / yearlen
    it1 = jnp.floor(t + 0.5).astype(jnp.int32)
    it2 = it1 + 1
    wt1 = (it1.astype(jnp.float32) + 0.5) - t
    wt2 = 1.0 - wt1
    it1 = jnp.where(it1 < 1, 12, it1)
    it2 = jnp.where(it2 > 12, 1, it2)
    # p.laim is (12, ny, nx), month index 1-based
    lai = (wt1 * take_level(p.laim, it1 - 1)
           + wt2 * take_level(p.laim, it2 - 1))
    sai = (wt1 * take_level(p.saim, it1 - 1)
           + wt2 * take_level(p.saim, it2 - 1))
    sai = jnp.where(sai < 0.05, 0.0, sai)
    lai = jnp.where((lai < 0.05) | (sai == 0.0), 0.0, lai)
    novegcell = ((vegtype == p.iswater) | (vegtype == p.isbarren)
                 | (vegtype == p.isice) | p.urban_flag)
    lai = jnp.where(novegcell, 0.0, lai)
    sai = jnp.where(novegcell, 0.0, sai)

    # burial by snow
    db = jnp.minimum(jnp.maximum(snowh - p.hvb, 0.0), p.hvt - p.hvb)
    fb = db / jnp.maximum(1e-6, p.hvt - p.hvb)
    snowhc = p.hvt * jnp.exp(-snowh / 0.2)
    fb = jnp.where((p.hvt > 0.0) & (p.hvt <= 1.0),
                   jnp.minimum(snowh, snowhc) / jnp.maximum(snowhc, MPE),
                   fb)
    elai = lai * (1.0 - fb)
    esai = sai * (1.0 - fb)
    esai = jnp.where(esai < 0.05, 0.0, esai)
    elai = jnp.where((elai < 0.05) | (esai == 0.0), 0.0, elai)
    igs = (tv > p.tmin).astype(jnp.float32)
    return lai, sai, elai, esai, igs


# ==========================================================================
# canopy interception + advected precip heat (PRECIP_HEAT, :1309-1536)
# ==========================================================================

def precip_heat(p, dt, uu, vv, elai, esai, fveg, bdfall, rain, snow, fp,
                canliq, canice, tv, sfctmp, tg):
    """Split of rain/snow into interception, drip and throughfall, and the
    heat they advect to canopy/ground. Returns a namespace + updated
    canliq/canice/fwet."""
    hasveg = (elai + esai) > 0.0
    maxliq = p.ch2op * (elai + esai)

    qintr = fveg * rain * fp
    qintr = jnp.minimum(
        qintr, (maxliq - canliq) / dt
        * (1.0 - jnp.exp(-rain * dt / jnp.maximum(maxliq, MPE))))
    qintr = jnp.maximum(qintr, 0.0)
    qintr = jnp.where(hasveg, qintr, 0.0)
    qdripr = jnp.where(hasveg, fveg * rain - qintr,
                       jnp.where(canliq > 0.0, canliq / dt, 0.0))
    qthror = jnp.where(hasveg, (1.0 - fveg) * rain, rain)
    canliq = jnp.where(hasveg, jnp.maximum(0.0, canliq + qintr * dt),
                       0.0)

    pah_ac = fveg * rain * (CWAT / 1000.0) * (sfctmp - tv)
    pah_cg = qdripr * (CWAT / 1000.0) * (tv - tg)
    pah_ag = qthror * (CWAT / 1000.0) * (sfctmp - tg)

    maxsno = 6.6 * (0.27 + 46.0 / bdfall) * (elai + esai)
    qints = fveg * snow * fp
    qints = jnp.minimum(
        qints, (maxsno - canice) / dt
        * (1.0 - jnp.exp(-snow * dt / jnp.maximum(maxsno, MPE))))
    qints = jnp.maximum(qints, 0.0)
    qints = jnp.where(hasveg, qints, 0.0)
    ft = jnp.maximum(0.0, (tv - 270.15) / 1.87e5)
    fv = jnp.sqrt(uu * uu + vv * vv) / 1.56e5
    icedrip = jnp.where(hasveg, jnp.maximum(0.0, canice) * (fv + ft), 0.0)
    qdrips = jnp.where(hasveg, (fveg * snow - qints) + icedrip,
                       jnp.where(canice > 0.0, canice / dt, 0.0))
    qthros = jnp.where(hasveg, (1.0 - fveg) * snow, snow)
    canice = jnp.where(hasveg,
                       jnp.maximum(0.0, canice + (qints - icedrip) * dt),
                       0.0)

    fwet = jnp.where(canice > 0.0,
                     jnp.maximum(0.0, canice) / jnp.maximum(maxsno, 1e-6),
                     jnp.maximum(0.0, canliq) / jnp.maximum(maxliq, 1e-6))
    fwet = jnp.minimum(fwet, 1.0) ** 0.667
    cmc = canliq + canice

    pah_ac = pah_ac + fveg * snow * (CICE / 1000.0) * (sfctmp - tv)
    pah_cg = pah_cg + qdrips * (CICE / 1000.0) * (tv - tg)
    pah_ag = pah_ag + qthros * (CICE / 1000.0) * (sfctmp - tg)

    pahv = pah_ac - pah_cg
    pahg = pah_cg
    pahb = pah_ag
    mid = (fveg > 0.0) & (fveg < 1.0)
    pahg = jnp.where(mid, pahg / jnp.maximum(fveg, MPE), pahg)
    pahb = jnp.where(mid, pahb / jnp.maximum(1.0 - fveg, MPE), pahb)
    noveg = fveg <= 0.0
    pahb = jnp.where(noveg, pahg + pahb, pahb)
    pahg = jnp.where(noveg, 0.0, pahg)
    pahv = jnp.where(noveg, 0.0, pahv)
    pahb = jnp.where(fveg >= 1.0, 0.0, pahb)
    pahv = jnp.clip(pahv, -20.0, 20.0)
    pahg = jnp.clip(pahg, -20.0, 20.0)
    pahb = jnp.clip(pahb, -20.0, 20.0)

    qrain = qdripr + qthror
    qsnow = qdrips + qthros
    snowhin = qsnow / bdfall
    return SimpleNamespace(
        qintr=qintr, qdripr=qdripr, qthror=qthror, qints=qints,
        qdrips=qdrips, qthros=qthros, pahv=pahv, pahg=pahg, pahb=pahb,
        qrain=qrain, qsnow=qsnow, snowhin=snowhin, fwet=fwet, cmc=cmc,
        canliq=canliq, canice=canice)


# ==========================================================================
# thermal properties (THERMOPROP/CSNOW/TDFCND, :2336-2615)
# ==========================================================================

def csnow(isnow, snice, snliq, dzsnso):
    """Snow bulk density -> volumetric heat capacity + conductivity
    (CSNOW; Stieglitz / Yen 1965). Snow arrays are the top NSNOW rows of
    the stack."""
    dz = jnp.maximum(dzsnso[:NSNOW], MPE)
    snicev = jnp.minimum(1.0, snice / (dz * DENICE))
    epore = 1.0 - snicev
    snliqv = jnp.minimum(epore, snliq / (dz * DENH2O))
    bdsnoi = (snice + snliq) / dz
    cvsno = CICE * snicev + CWAT * snliqv
    tksno = 3.2217e-6 * bdsnoi ** 2
    return tksno, cvsno, snicev, snliqv, epore


def tdfcnd(p, smc, sh2o):
    """Soil thermal conductivity, Johansen as in Noah (TDFCND).
    smc/sh2o: (NSOIL, ny, nx); p.smcmax/quartz: (ny, nx)."""
    satratio = smc / p.smcmax[None]
    thks = 7.7 ** p.quartz[None] * 2.0 ** (1.0 - p.quartz[None])
    xunfroz = jnp.where(smc > 0.0, sh2o / jnp.maximum(smc, MPE), 1.0)
    xu = xunfroz * p.smcmax[None]
    thksat = (thks ** (1.0 - p.smcmax[None]) * TKICE ** (p.smcmax[None] - xu)
              * 0.57 ** xu)
    gammd = (1.0 - p.smcmax[None]) * 2700.0
    thkdry = (0.135 * gammd + 64.7) / (2700.0 - 0.947 * gammd)
    ake_unfrozen = jnp.where(satratio > 0.1,
                             jnp.log10(jnp.maximum(satratio, 0.1)) + 1.0,
                             0.0)
    ake = jnp.where((sh2o + 0.0005) < smc, satratio, ake_unfrozen)
    return ake * (thksat - thkdry) + thkdry


def thermoprop(p, isnow, dzsnso, dt, snowh, snice, snliq, smc, sh2o):
    """Layer conductivities/heat capacities + FACT (THERMOPROP). IST=1
    (soil). Returns (df, hcpct, snicev, snliqv, epore, fact), all on the
    7-layer stack (snow part masked by isnow)."""
    tksno, cvsno, snicev, snliqv, epore = csnow(isnow, snice, snliq, dzsnso)
    sice = smc - sh2o
    hcpct_soil = (sh2o * CWAT + (1.0 - p.smcmax[None]) * p.csoil
                  + (p.smcmax[None] - smc) * CPAIR + sice * CICE)
    df_soil = tdfcnd(p, smc, sh2o)
    df_soil = jnp.where(p.urban_flag[None], 3.24, df_soil)
    df = jnp.concatenate([tksno, df_soil], axis=0)
    hcpct = jnp.concatenate([cvsno, hcpct_soil], axis=0)
    fact = dt / (jnp.maximum(hcpct, MPE) * jnp.maximum(dzsnso, MPE))
    # blend the top-soil conductivity with thin (layerless) snow, or with
    # the bottom snow layer (:2418-2422)
    m0 = NSNOW - 1   # stack index of snow layer j=0
    df1_nosnow = ((df[NSNOW] * dzsnso[NSNOW] + 0.35 * snowh)
                  / (snowh + dzsnso[NSNOW]))
    df1_snow = ((df[NSNOW] * dzsnso[NSNOW] + df[m0] * dzsnso[m0])
                / jnp.maximum(dzsnso[m0] + dzsnso[NSNOW], MPE))
    df = df.at[NSNOW].set(jnp.where(isnow == 0, df1_nosnow, df1_snow))
    return df, hcpct, snicev, snliqv, epore, fact


# ==========================================================================
# radiation (RADIATION/ALBEDO/TWOSTREAM/SURRAD etc., :2617-3525)
# ==========================================================================

def snow_age(p, dt, tg, sneqvo, sneqv, tauss):
    """BATS non-dimensional snow age (SNOW_AGE; Yang et al. 1997)."""
    dela0 = dt / p.tau0
    arg = p.grain_growth * (1.0 / TFRZ - 1.0 / tg)
    age1 = jnp.exp(arg)
    age2 = jnp.exp(jnp.minimum(0.0, p.extra_growth * arg))
    tage = age1 + age2 + p.dirt_soot
    dela = dela0 * tage
    dels = jnp.maximum(0.0, sneqv - sneqvo) / p.swemx
    sge = (tauss + dela) * (1.0 - dels)
    tauss = jnp.where(sneqv <= 0.0, 0.0, jnp.maximum(0.0, sge))
    fage = tauss / (tauss + 1.0)
    return tauss, fage


def snowalb_bats(p, cosz, fage):
    """BATS snow albedo, direct/diffuse x vis/nir (SNOWALB_BATS)."""
    sl = p.bats_cosz
    cf1 = (1.0 + 1.0 / sl) / (1.0 + 2.0 * sl * cosz) - 1.0 / sl
    fzen = jnp.maximum(cf1, 0.0)
    albsni = jnp.stack([p.bats_vis_new * (1.0 - p.bats_vis_age * fage),
                        p.bats_nir_new * (1.0 - p.bats_nir_age * fage)])
    albsnd = albsni + p.bats_vis_dir * fzen[None] * (1.0 - albsni)
    return albsnd, albsni


def groundalb(p, fsno, smc1, albsnd, albsni):
    """Bare ground + snow composite albedo (GROUNDALB, IST=1 soil)."""
    inc = jnp.maximum(0.11 - 0.40 * smc1, 0.0)
    albsod = jnp.minimum(p.albsat + inc[None], p.albdry)
    albgrd = albsod * (1.0 - fsno[None]) + albsnd * fsno[None]
    albgri = albsod * (1.0 - fsno[None]) + albsni * fsno[None]
    return albgrd, albgri


def twostream(p, ib, ic, cosz, vai, fwet, t, albg, rho, tau, fveg):
    """Dickinson/Sellers two-stream canopy radiative transfer with the
    Niu & Yang (2004) gap treatment (TWOSTREAM, :3276-3523; OPT_RAD=1).

    albg: relevant ground albedo (direct for ic=0, diffuse for ic=1),
    rho/tau: band values (ny, nx). Returns (fab, fre, ftd, fti, gdir,
    frev, freg, bgap, wgap)."""
    pai = np.pi
    denfveg = -jnp.log(jnp.maximum(1.0 - fveg, 0.01)) / (pai * p.rc ** 2)
    hd = p.hvt - p.hvb
    bb = 0.5 * hd
    thetap = jnp.arctan(bb / jnp.maximum(p.rc, MPE)
                        * jnp.tan(jnp.arccos(jnp.maximum(0.01, cosz))))
    bgap = jnp.exp(-denfveg * pai * p.rc ** 2
                   / jnp.maximum(jnp.cos(thetap), MPE))
    fa = vai / jnp.maximum(
        1.33 * pai * p.rc ** 3 * (bb / jnp.maximum(p.rc, MPE)) * denfveg,
        MPE)
    newvai = hd * fa
    wgap = (1.0 - bgap) * jnp.exp(-0.5 * newvai
                                  / jnp.maximum(cosz, 0.001))
    gap = jnp.minimum(1.0 - fveg, bgap + wgap)
    kopen = jnp.full_like(gap, 0.05)
    novai = vai == 0.0
    gap = jnp.where(novai, 1.0, gap)
    kopen = jnp.where(novai, 1.0, kopen)

    coszi = jnp.maximum(0.001, cosz)
    chil = jnp.clip(p.xl, -0.4, 0.6)
    chil = jnp.where(jnp.abs(chil) <= 0.01, 0.01, chil)
    phi1 = 0.5 - 0.633 * chil - 0.330 * chil * chil
    phi2 = 0.877 * (1.0 - 2.0 * phi1)
    gdir = phi1 + phi2 * coszi
    ext = gdir / coszi
    avmu = (1.0 - phi1 / phi2 * jnp.log((phi1 + phi2)
                                        / jnp.maximum(phi1, MPE))) / phi2
    omegal = rho + tau
    tmp0 = gdir + phi2 * coszi
    tmp1 = phi1 * coszi
    asu = (0.5 * omegal * gdir / tmp0
           * (1.0 - tmp1 / tmp0
              * jnp.log((tmp1 + tmp0) / jnp.maximum(tmp1, MPE))))
    betadl = (1.0 + avmu * ext) / (omegal * avmu * ext) * asu
    betail = 0.5 * (rho + tau + (rho - tau)
                    * ((1.0 + chil) / 2.0) ** 2) / omegal
    # adjust for intercepted snow (frozen canopy)
    omegas_b = float(p.omegas[ib])
    frozen = t <= TFRZ
    om_f = (1.0 - fwet) * omegal + fwet * omegas_b
    bd_f = ((1.0 - fwet) * omegal * betadl
            + fwet * omegas_b * p.betads) / om_f
    bi_f = ((1.0 - fwet) * omegal * betail
            + fwet * omegas_b * p.betais) / om_f
    omega = jnp.where(frozen, om_f, omegal)
    betad = jnp.where(frozen, bd_f, betadl)
    betai = jnp.where(frozen, bi_f, betail)

    b = 1.0 - omega + omega * betai
    c = omega * betai
    tmp0 = avmu * ext
    d = tmp0 * omega * betad
    f = tmp0 * omega * (1.0 - betad)
    tmp1 = b * b - c * c
    h = jnp.sqrt(jnp.maximum(tmp1, 0.0)) / avmu
    sigma = tmp0 * tmp0 - tmp1
    sigma = jnp.where(jnp.abs(sigma) < 1e-6,
                      jnp.where(sigma >= 0, 1e-6, -1e-6), sigma)
    p1 = b + avmu * h
    p2 = b - avmu * h
    p3 = b + tmp0
    p4 = b - tmp0
    s1 = jnp.exp(-jnp.minimum(h * vai, 50.0))
    s2 = jnp.exp(-jnp.minimum(ext * vai, 50.0))
    u1 = b - c / jnp.maximum(albg, MPE)
    u2 = b - c * albg
    u3 = f + c * albg
    tmp2 = u1 - avmu * h
    tmp3 = u1 + avmu * h
    d1 = p1 * tmp2 / s1 - p2 * tmp3 * s1
    tmp4 = u2 + avmu * h
    tmp5 = u2 - avmu * h
    d2 = tmp4 / s1 - tmp5 * s1
    h1 = -d * p4 - c * f
    tmp6 = d - h1 * p3 / sigma
    tmp7 = (d - c - h1 / sigma * (u1 + tmp0)) * s2
    h2 = (tmp6 * tmp2 / s1 - p2 * tmp7) / d1
    h3 = -(tmp6 * tmp3 * s1 - p1 * tmp7) / d1
    h4 = -f * p3 - c * d
    tmp8 = h4 / sigma
    tmp9 = (u3 - tmp8 * (u2 - tmp0)) * s2
    h5 = -(tmp8 * tmp4 / s1 + tmp9) / d2
    h6 = (tmp8 * tmp5 * s1 + tmp9) / d2
    h7 = (c * tmp2) / (d1 * s1)
    h8 = (-c * tmp3 * s1) / d1
    h9 = tmp4 / (d2 * s1)
    h10 = (-tmp5 * s1) / d2

    if ic == 0:
        ftd = s2 * (1.0 - gap) + gap
        fti = (h4 * s2 / sigma + h5 * s1 + h6 / s1) * (1.0 - gap)
        fre = (h1 / sigma + h2 + h3) * (1.0 - gap) + albg * gap
        frev = (h1 / sigma + h2 + h3) * (1.0 - gap)
        freg = albg * gap
    else:
        ftd = jnp.zeros_like(s2)
        fti = (h9 * s1 + h10 / s1) * (1.0 - kopen) + kopen
        fre = (h7 + h8) * (1.0 - kopen) + albg * kopen
        frev = fre
        freg = jnp.zeros_like(fre)
    fab = 1.0 - fre - (1.0 - albg) * ftd - (1.0 - albg) * fti
    # NOTE: the reference uses ALBGRD for the direct term and ALBGRI for
    # the diffuse term in FAB; with ic fixed, albg is the matching one for
    # ftd and the DIFFUSE ground albedo must weight fti. Callers pass both.
    return SimpleNamespace(fab=fab, fre=fre, ftd=ftd, fti=fti, gdir=gdir,
                           frev=frev, freg=freg, bgap=bgap, wgap=wgap)


def albedo_rad(p, dt, cosz, elai, esai, tg, tv, fsno, qsnow, fwet, smc1,
               sneqvo, sneqv, fveg, tauss, vegtype):
    """Surface albedos + canopy fluxes per unit radiation (ALBEDO) and
    the absorbed-flux partition (SURRAD wiring happens in radiation()).
    Returns a namespace; all band arrays are (2, ny, nx)."""
    vai = elai + esai
    wl = elai / jnp.maximum(vai, MPE)
    ws = esai / jnp.maximum(vai, MPE)
    rho = jnp.maximum(p.rhol * wl[None] + p.rhos * ws[None], MPE)
    tau = jnp.maximum(p.taul * wl[None] + p.taus * ws[None], MPE)

    tauss, fage = snow_age(p, dt, tg, sneqvo, sneqv, tauss)
    albsnd, albsni = snowalb_bats(p, cosz, fage)
    albgrd, albgri = groundalb(p, fsno, smc1, albsnd, albsni)

    fabd, albd, ftdd, ftid = [], [], [], []
    fabi, albi, ftdi_, ftii = [], [], [], []
    frevd, fregd, frevi, fregi = [], [], [], []
    gdir = None
    bgap = wgap = None
    for ib in range(2):
        td = twostream(p, ib, 0, cosz, vai, fwet, tv, albgrd[ib],
                       rho[ib], tau[ib], fveg)
        ti = twostream(p, ib, 1, cosz, vai, fwet, tv, albgri[ib],
                       rho[ib], tau[ib], fveg)
        # FAB mixes direct & diffuse ground albedo terms (:3500-3501)
        fab_d = (1.0 - td.fre - (1.0 - albgrd[ib]) * td.ftd
                 - (1.0 - albgri[ib]) * td.fti)
        fab_i = (1.0 - ti.fre - (1.0 - albgrd[ib]) * ti.ftd
                 - (1.0 - albgri[ib]) * ti.fti)
        fabd.append(fab_d)
        albd.append(td.fre)
        ftdd.append(td.ftd)
        ftid.append(td.fti)
        frevd.append(td.frev)
        fregd.append(td.freg)
        fabi.append(fab_i)
        albi.append(ti.fre)
        ftdi_.append(ti.ftd)
        ftii.append(ti.fti)
        frevi.append(ti.frev)
        fregi.append(ti.freg)
        if ib == 0:
            gdir = td.gdir
            bgap, wgap = td.bgap, td.wgap
    stackb = lambda lst: jnp.stack(lst)
    out = SimpleNamespace(
        albgrd=albgrd, albgri=albgri, albd=stackb(albd), albi=stackb(albi),
        fabd=stackb(fabd), fabi=stackb(fabi), ftdd=stackb(ftdd),
        ftid=stackb(ftid), ftii=stackb(ftii), frevd=stackb(frevd),
        fregd=stackb(fregd), frevi=stackb(frevi), fregi=stackb(fregi),
        albsnd=albsnd, albsni=albsni, tauss=tauss, bgap=bgap, wgap=wgap)

    # sunlit canopy fraction
    ext = gdir / jnp.maximum(cosz, 0.001) * jnp.sqrt(
        jnp.maximum(1.0 - rho[0] - tau[0], 0.0))
    fsun = (1.0 - jnp.exp(-jnp.minimum(ext * vai, 50.0))) \
        / jnp.maximum(ext * vai, MPE)
    fsun = jnp.where(fsun < 0.01, 0.0, fsun)
    # zero everything when the sun is down (:2860-2874 GOTO 100)
    dark = cosz <= 0.0
    for k in ("albd", "albi", "fabd", "fabi", "ftdd", "ftid", "ftii",
              "albgrd", "albgri", "albsnd", "albsni", "frevd", "fregd",
              "frevi", "fregi"):
        out.__dict__[k] = jnp.where(dark[None], 0.0, out.__dict__[k])
    out.fsun = jnp.where(dark, 0.0, fsun)
    return out


def radiation(p, dt, cosz, elai, esai, tg, tv, fsno, qsnow, fwet, smc1,
              sneqvo, sneqv, fveg, tauss, vegtype, solad, solai):
    """Absorbed/reflected solar partition (RADIATION + SURRAD)."""
    a = albedo_rad(p, dt, cosz, elai, esai, tg, tv, fsno, qsnow, fwet,
                   smc1, sneqvo, sneqv, fveg, tauss, vegtype)
    fsun = a.fsun
    fsha = 1.0 - fsun
    laisun = elai * fsun
    laisha = elai * fsha
    vai = elai + esai

    cad = solad * a.fabd
    cai = solai * a.fabi
    sav = jnp.sum(cad + cai, axis=0)
    trd = solad * a.ftdd
    tri = solad * a.ftid + solai * a.ftii
    absg = trd * (1.0 - a.albgrd) + tri * (1.0 - a.albgri)
    sag = jnp.sum(absg, axis=0)
    fsa = sav + sag

    laifra = elai / jnp.maximum(vai, MPE)
    parsun = jnp.where(
        fsun > 0.0,
        (cad[0] + fsun * cai[0]) * laifra / jnp.maximum(laisun, MPE),
        0.0)
    parsha = jnp.where(
        fsun > 0.0,
        (fsha * cai[0]) * laifra / jnp.maximum(laisha, MPE),
        (cad[0] + cai[0]) * laifra / jnp.maximum(laisha, MPE))
    fsr = jnp.sum(a.albd * solad + a.albi * solai, axis=0)
    fsrv = jnp.sum(a.frevd * solad + a.frevi * solai, axis=0)
    fsrg = jnp.sum(a.fregd * solad + a.fregi * solai, axis=0)
    return SimpleNamespace(
        fsun=fsun, laisun=laisun, laisha=laisha, parsun=parsun,
        parsha=parsha, sav=sav, sag=sag, fsa=fsa, fsr=fsr, fsrv=fsrv,
        fsrg=fsrg, tauss=a.tauss, albd=a.albd, albi=a.albi,
        albsnd=a.albsnd, albsni=a.albsni, bgap=a.bgap, wgap=a.wgap)


# ==========================================================================
# saturation vapor pressure (ESAT, :4900-4951)
# ==========================================================================

def esat(t):
    """Flatau polynomial esat & d(esat)/dT over water and ice; t in deg C
    (clamped to +-50 by callers)."""
    a = [6.107799961, 4.436518521e-01, 1.428945805e-02, 2.650648471e-04,
         3.031240396e-06, 2.034080948e-08, 6.136820929e-11]
    b = [6.109177956, 5.034698970e-01, 1.886013408e-02, 4.176223716e-04,
         5.824720280e-06, 4.838803174e-08, 1.838826904e-10]
    c = [4.438099984e-01, 2.857002636e-02, 7.938054040e-04,
         1.215215065e-05, 1.036561403e-07, 3.532421810e-10,
         -7.090244804e-13]
    d = [5.030305237e-01, 3.773255020e-02, 1.267995369e-03,
         2.477563108e-05, 3.005693132e-07, 2.158542548e-09,
         7.131097725e-12]

    def poly(cf):
        r = jnp.asarray(cf[-1], jnp.float32)
        for v in cf[-2::-1]:
            r = v + t * r
        return 100.0 * r
    return poly(a), poly(b), poly(c), poly(d)


def _estg(t_k):
    """esat and d/dT at temperature t_k, water above 0 C else ice."""
    t = jnp.clip(t_k - TFRZ, -50.0, 50.0)
    esw, esi, dsw, dsi = esat(t)
    warm = t > 0.0
    return jnp.where(warm, esw, esi), jnp.where(warm, dsw, dsi)


# ==========================================================================
# Monin-Obukhov surface exchange (SFCDIF1, :4529-4692; OPT_SFC=1)
# ==========================================================================

def sfcdif1(st, it, sfctmp, rhoair, h, qair, zlvl, zpd, z0m, z0h, ur):
    """One iteration of the M-O exchange-coefficient update. ``st`` is the
    per-column iteration state dict (moz, mozsgn, fm, fh, fm2, fh2, fv);
    ``it`` is the 1-based static iteration index."""
    mozold = st["moz"]
    tmpcm = jnp.log((zlvl - zpd) / z0m)
    tmpch = jnp.log((zlvl - zpd) / z0h)
    tmpcm2 = jnp.log((2.0 + z0m) / z0m)
    tmpch2 = jnp.log((2.0 + z0h) / z0h)

    if it == 1:
        fv = jnp.zeros_like(sfctmp)
        moz = jnp.zeros_like(sfctmp)
        moz2 = jnp.zeros_like(sfctmp)
    else:
        fv = st["fv"]
        tvir = (1.0 + 0.61 * qair) * sfctmp
        tmp1 = VKC * (GRAV / tvir) * h / (rhoair * CPAIR)
        tmp1 = jnp.where(jnp.abs(tmp1) <= MPE, MPE, tmp1)
        mol = -1.0 * fv ** 3 / tmp1
        moz = jnp.minimum((zlvl - zpd) / mol, 1.0)
        moz2 = jnp.minimum((2.0 + z0h) / mol, 1.0)

    mozsgn = st["mozsgn"] + (mozold * moz < 0.0).astype(jnp.int32)
    flip2 = mozsgn >= 2
    moz = jnp.where(flip2, 0.0, moz)
    moz2 = jnp.where(flip2, 0.0, moz2)
    fm = jnp.where(flip2, 0.0, st["fm"])
    fh = jnp.where(flip2, 0.0, st["fh"])
    fm2 = jnp.where(flip2, 0.0, st["fm2"])
    fh2 = jnp.where(flip2, 0.0, st["fh2"])

    def stab(m):
        t1 = (1.0 - 16.0 * jnp.minimum(m, 0.0)) ** 0.25
        t2 = jnp.log((1.0 + t1 * t1) / 2.0)
        t3 = jnp.log((1.0 + t1) / 2.0)
        fm_u = 2.0 * t3 + t2 - 2.0 * jnp.arctan(t1) + 1.5707963
        fh_u = 2.0 * t2
        fm_s = -5.0 * m
        return (jnp.where(m < 0.0, fm_u, fm_s),
                jnp.where(m < 0.0, fh_u, fm_s))

    fmnew, fhnew = stab(moz)
    fm2new, fh2new = stab(moz2)
    if it == 1:
        fm, fh, fm2, fh2 = fmnew, fhnew, fm2new, fh2new
    else:
        fm = 0.5 * (fm + fmnew)
        fh = 0.5 * (fh + fhnew)
        fm2 = 0.5 * (fm2 + fm2new)
        fh2 = 0.5 * (fh2 + fh2new)
    fh = jnp.minimum(fh, 0.9 * tmpch)
    fm = jnp.minimum(fm, 0.9 * tmpcm)
    fh2 = jnp.minimum(fh2, 0.9 * tmpch2)
    fm2 = jnp.minimum(fm2, 0.9 * tmpcm2)

    def nz(x):
        return jnp.where(jnp.abs(x) <= MPE, MPE, x)
    cmfm = nz(tmpcm - fm)
    chfh = nz(tmpch - fh)
    cm2fm2 = nz(tmpcm2 - fm2)
    ch2fh2 = nz(tmpch2 - fh2)
    cm = VKC * VKC / (cmfm * cmfm)
    ch = VKC * VKC / (cmfm * chfh)
    fv = ur * jnp.sqrt(cm)
    ch2 = VKC * fv / ch2fh2
    return dict(moz=moz, mozsgn=mozsgn, fm=fm, fh=fh, fm2=fm2, fh2=fh2,
                fv=fv, cm=cm, ch=ch, ch2=ch2)


def ragrb(p, it, st, vai, rhoair, hg, tah, zpd, z0mg, z0hg, hcan, uc,
          z0h, fv, tv):
    """Below-canopy aerodynamic + leaf boundary-layer resistance
    (RAGRB, :4429-4527)."""
    if it == 1:
        fhg_prev = None
        mozg = jnp.zeros_like(tah)
    else:
        tmp1 = VKC * (GRAV / tah) * hg / (rhoair * CPAIR)
        tmp1 = jnp.where(jnp.abs(tmp1) <= MPE, MPE, tmp1)
        molg = -1.0 * fv ** 3 / tmp1
        mozg = jnp.minimum((zpd - z0mg) / molg, 1.0)
        fhg_prev = st["fhg"]
    fhgnew = jnp.where(mozg < 0.0,
                       (1.0 - 15.0 * mozg) ** (-0.25),
                       1.0 + 4.7 * mozg)
    fhg = fhgnew if it == 1 else 0.5 * (fhg_prev + fhgnew)

    cwpc = jnp.sqrt(jnp.maximum(p.cwpvt * vai * hcan * fhg, MPE))
    tmp1 = jnp.exp(-cwpc * z0hg / hcan)
    tmp2 = jnp.exp(-cwpc * (z0h + zpd) / hcan)
    tmprah2 = hcan * jnp.exp(jnp.minimum(cwpc, 50.0)) / cwpc * (tmp1 - tmp2)
    kh = jnp.maximum(VKC * fv * (hcan - zpd), MPE)
    rahg = tmprah2 / kh
    tmprb = cwpc * 50.0 / (1.0 - jnp.exp(-cwpc / 2.0))
    rb = tmprb * jnp.sqrt(p.dleaf / jnp.maximum(uc, MPE))
    rb = jnp.clip(rb, 5.0, 50.0)
    return dict(fhg=fhg, ramg=jnp.zeros_like(rahg), rahg=rahg, rawg=rahg,
                rb=rb)


# ==========================================================================
# Ball-Berry stomatal resistance (STOMATA, :4953-5084; OPT_CRS=1)
# ==========================================================================

def stomata(p, apar, foln, tv, ei, ea, sfctmp, sfcprs, o2, co2, igs,
            btran, rb):
    """Ball-Berry / Collatz photosynthesis-conductance model. Returns
    (rs, psn)."""
    cf = sfcprs / (8.314 * sfctmp) * 1e6
    rs0 = 1.0 / p.bp * cf
    fnf = jnp.minimum(foln / jnp.maximum(MPE, p.folnmx), 1.0)
    tc = tv - TFRZ
    ppf = 4.6 * apar
    j = ppf * p.qe25

    def f1(ab, bc):
        return ab ** ((bc - 25.0) / 10.0)

    def f2(ab):
        return 1.0 + jnp.exp((-2.2e5 + 710.0 * (ab + 273.16))
                             / (8.314 * (ab + 273.16)))

    kc = p.kc25 * f1(p.akc, tc)
    ko = p.ko25 * f1(p.ako, tc)
    awc = kc * (1.0 + o2 / ko)
    cp = 0.5 * kc / ko * o2 * 0.21
    vcmx = p.vcmx25 / f2(tc) * fnf * btran * f1(p.avcmx, tc)
    ci = 0.7 * co2 * p.c3psn + 0.4 * co2 * (1.0 - p.c3psn)
    rlb = rb / cf
    cea = jnp.maximum(0.25 * ei * p.c3psn + 0.40 * ei * (1.0 - p.c3psn),
                      jnp.minimum(ea, ei))

    rs, psn = rs0, jnp.zeros_like(rs0)
    for _ in range(3):
        wj = (jnp.maximum(ci - cp, 0.0) * j / (ci + 2.0 * cp) * p.c3psn
              + j * (1.0 - p.c3psn))
        wc = (jnp.maximum(ci - cp, 0.0) * vcmx / (ci + awc) * p.c3psn
              + vcmx * (1.0 - p.c3psn))
        we = 0.5 * vcmx * p.c3psn + 4000.0 * vcmx * ci / sfcprs \
            * (1.0 - p.c3psn)
        psn = jnp.minimum(jnp.minimum(wj, wc), we) * igs
        cs = jnp.maximum(co2 - 1.37 * rlb * sfcprs * psn, MPE)
        a = p.mp * psn * sfcprs * cea / (cs * ei) + p.bp
        b = (p.mp * psn * sfcprs / cs + p.bp) * rlb - 1.0
        c = -rlb
        disc = jnp.sqrt(jnp.maximum(b * b - 4.0 * a * c, 0.0))
        q = jnp.where(b >= 0.0, -0.5 * (b + disc), -0.5 * (b - disc))
        rs = jnp.maximum(q / a, c / q)
        ci = jnp.maximum(cs - psn * sfcprs * 1.65 * rs, 0.0)

    dark = apar <= 0.0
    return (jnp.where(dark, rs0, rs * cf),
            jnp.where(dark, 0.0, psn))


# ==========================================================================
# canopy energy balance (VEGE_FLUX, :3526-4118)
# ==========================================================================

NITERC = 20
NITERG = 5
NITERB = 5


def vege_flux(p, isnow, dt, sav, sag, lwdn, ur, uu, vv, sfctmp, thair,
              qair, eair, rhoair, snowh, vai, gammav, gammag, fwet,
              laisun, laisha, dzsnso, zlvl, zpd, z0m, fveg, z0mg,
              canliq, canice, stc, df, rsurf, latheav, latheag, parsun,
              parsha, igs, foln, co2air, o2air, btran, sfcprs, rhsur,
              q2, pahv, pahg, eah, tah, tv, tg, cm, ch, fsno, emv, emg):
    """Vegetated-fraction energy balance: iterative solution for leaf
    temperature TV (NITERC Newton steps with M-O exchange updates) then
    ground temperature TG under the canopy (NITERG steps).

    The reference's early-exit (LITER) becomes a freeze mask: once
    |dTV| <= 0.01 after iteration 5, one more full iteration runs and
    subsequent ones stop updating that column (matching loop1's
    exit-at-top-of-next-iteration semantics).
    """
    vaie = jnp.minimum(6.0, vai)
    laisune = jnp.minimum(6.0, laisun)
    laishae = jnp.minimum(6.0, laisha)

    estg, _ = _estg(tg)
    qsfc = 0.622 * eair / (sfcprs - 0.378 * eair)
    hcan = p.hvt
    uc = ur * jnp.log((hcan - zpd + z0m) / z0m) / jnp.log(zlvl / z0m)

    air = -emv * (1.0 + (1.0 - emv) * (1.0 - emg)) * lwdn \
        - emv * emg * SB * tg ** 4
    cir = (2.0 - emv * (1.0 - emg)) * emv * SB

    st = dict(moz=jnp.zeros_like(tv), mozsgn=jnp.zeros_like(tv, jnp.int32),
              fm=jnp.zeros_like(tv), fh=jnp.zeros_like(tv),
              fm2=jnp.zeros_like(tv), fh2=jnp.zeros_like(tv),
              fv=jnp.full_like(tv, 0.1), fhg=jnp.ones_like(tv))
    h = jnp.zeros_like(tv)
    hg = jnp.zeros_like(tv)
    dtv = jnp.zeros_like(tv)
    liter = jnp.zeros_like(tv, bool)    # converged: run one last iteration
    exited = jnp.zeros_like(tv, bool)   # stop updating
    irc = shc = evc = tr = jnp.zeros_like(tv)
    rssun = jnp.full_like(tv, 1e5)
    rssha = jnp.full_like(tv, 1e5)
    psnsun = jnp.zeros_like(tv)
    psnsha = jnp.zeros_like(tv)
    rb = jnp.full_like(tv, 50.0)
    rahc = rahg_ = rawg_ = jnp.ones_like(tv)
    cah2 = jnp.zeros_like(tv)
    z0h = z0m
    z0hg = z0mg

    # m-index of the top active layer (j = isnow+1 -> m = isnow+NSNOW)
    mtop = isnow + NSNOW
    stc_top = _gather_m(stc, mtop)
    df_top = _gather_m(df, mtop)
    dz_top = _gather_m(dzsnso, mtop)

    for it in range(1, NITERC + 1):
        upd = ~exited
        sd = sfcdif1(st, it, sfctmp, rhoair, h, qair, zlvl, zpd, z0m,
                     z0h, ur)
        for k in ("moz", "mozsgn", "fm", "fh", "fm2", "fh2", "fv"):
            st[k] = jnp.where(upd, sd[k], st[k])
        cm = jnp.where(upd, sd["cm"], cm)
        ch = jnp.where(upd, sd["ch"], ch)
        cah2 = jnp.where(upd, st["fv"] * VKC
                         / (jnp.log((2.0 + z0h) / z0h) - st["fh2"]), cah2)
        ramc = jnp.maximum(1.0, 1.0 / (cm * ur))
        rahc_n = jnp.maximum(1.0, 1.0 / (ch * ur))
        rahc = jnp.where(upd, rahc_n, rahc)
        rawc = rahc

        rg = ragrb(p, it, st, vaie, rhoair, hg, tah, zpd, z0mg, z0hg,
                   hcan, uc, z0h, st["fv"], tv)
        st["fhg"] = jnp.where(upd, rg["fhg"], st["fhg"])
        rahg_ = jnp.where(upd, rg["rahg"], rahg_)
        rawg_ = jnp.where(upd, rg["rawg"], rawg_)
        rb = jnp.where(upd, rg["rb"], rb)

        estv, destv = _estg(tv)

        if it == 1:
            rssun, psnsun = stomata(p, parsun, foln, tv, estv, eah,
                                    sfctmp, sfcprs, o2air, co2air, igs,
                                    btran, rb)
            rssha, psnsha = stomata(p, parsha, foln, tv, estv, eah,
                                    sfctmp, sfcprs, o2air, co2air, igs,
                                    btran, rb)

        cah = 1.0 / rahc
        cvh = 2.0 * vaie / rb
        cgh = 1.0 / rahg_
        cond = cah + cvh + cgh
        ata = (sfctmp * cah + tg * cgh) / cond
        bta = cvh / cond
        csh = (1.0 - bta) * rhoair * CPAIR * cvh
        caw = 1.0 / rawc
        cew = fwet * vaie / rb
        ctw = (1.0 - fwet) * (laisune / (rb + rssun)
                              + laishae / (rb + rssha))
        cgw = 1.0 / (rawg_ + rsurf)
        cond = caw + cew + ctw + cgw
        aea = (eair * caw + estg * cgw) / cond
        bea = (cew + ctw) / cond
        cev = (1.0 - bea) * cew * rhoair * CPAIR / gammav
        ctr = (1.0 - bea) * ctw * rhoair * CPAIR / gammav

        tah_n = ata + bta * tv
        eah_n = aea + bea * estv
        irc_n = fveg * (air + cir * tv ** 4)
        shc_n = fveg * rhoair * CPAIR * cvh * (tv - tah_n)
        evc_n = fveg * rhoair * CPAIR * cew * (estv - eah_n) / gammav
        tr_n = fveg * rhoair * CPAIR * ctw * (estv - eah_n) / gammav
        evc_n = jnp.where(tv > TFRZ,
                          jnp.minimum(canliq * latheav / dt, evc_n),
                          jnp.minimum(canice * latheav / dt, evc_n))
        b = sav - irc_n - shc_n - evc_n - tr_n + pahv
        a = fveg * (4.0 * cir * tv ** 3 + csh + (cev + ctr) * destv)
        dtv_n = b / a
        irc_n = irc_n + fveg * 4.0 * cir * tv ** 3 * dtv_n
        shc_n = shc_n + fveg * csh * dtv_n
        evc_n = evc_n + fveg * cev * destv * dtv_n
        tr_n = tr_n + fveg * ctr * destv * dtv_n
        tv_n = tv + dtv_n
        h_n = rhoair * CPAIR * (tah_n - sfctmp) / rahc
        hg_n = rhoair * CPAIR * (tg - tah_n) / rahg_
        qsfc_n = (0.622 * eah_n) / (sfcprs - 0.378 * eah_n)

        tah = jnp.where(upd, tah_n, tah)
        eah = jnp.where(upd, eah_n, eah)
        irc = jnp.where(upd, irc_n, irc)
        shc = jnp.where(upd, shc_n, shc)
        evc = jnp.where(upd, evc_n, evc)
        tr = jnp.where(upd, tr_n, tr)
        tv = jnp.where(upd, tv_n, tv)
        h = jnp.where(upd, h_n, h)
        hg = jnp.where(upd, hg_n, hg)
        qsfc = jnp.where(upd, qsfc_n, qsfc)
        dtv = jnp.where(upd, dtv_n, dtv)

        exited = exited | liter
        if it >= 5:
            liter = liter | (~exited & (jnp.abs(dtv) <= 0.01))

    # under-canopy ground temperature (loop2)
    air = -emg * (1.0 - emv) * lwdn - emg * emv * SB * tv ** 4
    cir = emg * SB
    csh = rhoair * CPAIR / rahg_
    cev = rhoair * CPAIR / (gammag * (rawg_ + rsurf))
    cgh = 2.0 * df_top / dz_top
    irg = shg = evg = gh = jnp.zeros_like(tg)
    for _ in range(NITERG):
        estg, destg = _estg(tg)
        irg = cir * tg ** 4 + air
        shg = csh * (tg - tah)
        evg = cev * (estg * rhsur - eah)
        gh = cgh * (tg - stc_top)
        b = sag - irg - shg - evg - gh + pahg
        a = 4.0 * cir * tg ** 3 + csh + cev * destg + cgh
        dtg = b / a
        irg = irg + 4.0 * cir * tg ** 3 * dtg
        shg = shg + csh * dtg
        evg = evg + cev * destg * dtg
        gh = gh + cgh * dtg
        tg = tg + dtg

    # OPT_STC=1: cap TG at freezing while snow on ground (:4038-4048)
    estg, _ = _estg(tg)
    cap = (snowh > 0.05) & (tg > TFRZ)
    tg = jnp.where(cap, TFRZ, tg)
    irg = jnp.where(cap, cir * tg ** 4 - emg * (1.0 - emv) * lwdn
                    - emg * emv * SB * tv ** 4, irg)
    shg = jnp.where(cap, csh * (tg - tah), shg)
    evg = jnp.where(cap, cev * (estg * rhsur - eah), evg)
    gh = jnp.where(cap, sag + pahg - (irg + shg + evg), gh)

    tauxv = -rhoair * cm * ur * uu
    tauyv = -rhoair * cm * ur * vv
    cq2v = cah2
    small = cah2 < 1e-5
    t2mv = jnp.where(small, tah,
                     tah - (shg + shc / jnp.maximum(fveg, MPE))
                     / (rhoair * CPAIR) / jnp.maximum(cah2, MPE))
    q2v = jnp.where(small, qsfc,
                    qsfc - ((evc + tr) / jnp.maximum(fveg, MPE) + evg)
                    / (latheav * rhoair) / jnp.maximum(cq2v, MPE))
    ch = 1.0 / rahc
    chleaf = 2.0 * vaie / rb
    chuc = 1.0 / rahg_
    return SimpleNamespace(
        eah=eah, tah=tah, tv=tv, tg=tg, cm=cm, ch=ch, tauxv=tauxv,
        tauyv=tauyv, irg=irg, irc=irc, shg=shg, shc=shc, evg=evg, evc=evc,
        tr=tr, gh=gh, t2mv=t2mv, q2v=q2v, psnsun=psnsun, psnsha=psnsha,
        rssun=rssun, rssha=rssha, qsfc=qsfc, chleaf=chleaf, chuc=chuc,
        chv2=cah2, rb=rb)


def bare_flux(p, isnow, dt, sag, lwdn, ur, uu, vv, sfctmp, thair, qair,
              eair, rhoair, snowh, dzsnso, zlvl, zpd, z0m, fsno, emg,
              stc, df, rsurf, lathea, gamma, rhsur, q2, pahb, tgb, cm,
              ch, sfcprs):
    """Bare-ground energy balance, NITERB Newton iterations (BARE_FLUX,
    :4120-4427)."""
    cir = emg * SB
    mtop = isnow + NSNOW
    stc_top = _gather_m(stc, mtop)
    df_top = _gather_m(df, mtop)
    dz_top = _gather_m(dzsnso, mtop)
    cgh = 2.0 * df_top / dz_top

    st = dict(moz=jnp.zeros_like(tgb), mozsgn=jnp.zeros_like(tgb, jnp.int32),
              fm=jnp.zeros_like(tgb), fh=jnp.zeros_like(tgb),
              fm2=jnp.zeros_like(tgb), fh2=jnp.zeros_like(tgb),
              fv=jnp.full_like(tgb, 0.1))
    h = jnp.zeros_like(tgb)
    z0h = z0m
    qsfc = 0.622 * eair / (sfcprs - 0.378 * eair)
    irb = shb = evb = ghb = jnp.zeros_like(tgb)
    csh = cev = jnp.ones_like(tgb)
    ehb2 = jnp.zeros_like(tgb)
    for it in range(1, NITERB + 1):
        sd = sfcdif1(st, it, sfctmp, rhoair, h, qair, zlvl, zpd, z0m,
                     z0h, ur)
        for k in ("moz", "mozsgn", "fm", "fh", "fm2", "fh2", "fv"):
            st[k] = sd[k]
        cm, ch = sd["cm"], sd["ch"]
        ehb2 = st["fv"] * VKC / (jnp.log((2.0 + z0h) / z0h) - st["fh2"])
        rahb = jnp.maximum(1.0, 1.0 / (ch * ur))
        rawb = rahb
        estg, destg = _estg(tgb)
        csh = rhoair * CPAIR / rahb
        cev = rhoair * CPAIR / gamma / (rsurf + rawb)
        irb = cir * tgb ** 4 - emg * lwdn
        shb = csh * (tgb - sfctmp)
        evb = cev * (estg * rhsur - eair)
        ghb = cgh * (tgb - stc_top)
        b = sag - irb - shb - evb - ghb + pahb
        a = 4.0 * cir * tgb ** 3 + csh + cev * destg + cgh
        dtg = b / a
        irb = irb + 4.0 * cir * tgb ** 3 * dtg
        shb = shb + csh * dtg
        evb = evb + cev * destg * dtg
        ghb = ghb + cgh * dtg
        tgb = tgb + dtg
        h = csh * (tgb - sfctmp)
        estg, _ = _estg(tgb)
        qsfc = 0.622 * (estg * rhsur) / (sfcprs - 0.378 * (estg * rhsur))

    cap = (snowh > 0.05) & (tgb > TFRZ)
    tgb = jnp.where(cap, TFRZ, tgb)
    irb = jnp.where(cap, cir * tgb ** 4 - emg * lwdn, irb)
    shb = jnp.where(cap, csh * (tgb - sfctmp), shb)
    evb = jnp.where(cap, cev * (estg * rhsur - eair), evb)
    ghb = jnp.where(cap, sag + pahb - (irb + shb + evb), ghb)

    tauxb = -rhoair * cm * ur * uu
    tauyb = -rhoair * cm * ur * vv
    cq2b = ehb2
    small = ehb2 < 1e-5
    t2mb = jnp.where(small, tgb,
                     tgb - shb / (rhoair * CPAIR)
                     / jnp.maximum(ehb2, MPE))
    q2b = jnp.where(small, qsfc,
                    qsfc - evb / (lathea * rhoair)
                    * (1.0 / jnp.maximum(cq2b, MPE) + rsurf))
    ehb = 1.0 / jnp.maximum(1.0, 1.0 / (ch * ur))
    return SimpleNamespace(
        tgb=tgb, cm=cm, ch=ehb, tauxb=tauxb, tauyb=tauyb, irb=irb,
        shb=shb, evb=evb, ghb=ghb, t2mb=t2mb, q2b=q2b, qsfc=qsfc,
        chb2=ehb2)


# ==========================================================================
# snow/soil temperature (TSNOSOI/HRT/HSTEP/ROSR12, :5201-5541)
# ==========================================================================

def _thomas_stack(a, b, c, r, active):
    """Thomas solve over the 7-layer stack with variable top; inactive
    rows are identity rows with zero rhs (ROSR12, :5482-5539)."""
    a = jnp.where(active, a, 0.0)
    b = jnp.where(active, b, 1.0)
    c = jnp.where(active, c, 0.0)
    r = jnp.where(active, r, 0.0)
    n = a.shape[0]
    gam = [None] * n
    u = [None] * n
    bet = b[0]
    u[0] = r[0] / bet
    gam[0] = jnp.zeros_like(bet)
    for k in range(1, n):
        gam[k] = c[k - 1] / bet
        bet = b[k] - a[k] * gam[k]
        u[k] = (r[k] - a[k] * u[k - 1]) / bet
    for k in range(n - 2, -1, -1):
        u[k] = u[k] - gam[k + 1] * u[k + 1]
    return jnp.stack(u)


def tsnosoi(p, isnow, tbot, zsnso, ssoil, df, hcpct, dt, snowh, dzsnso,
            stc):
    """Semi-implicit snow/soil heat diffusion (TSNOSOI + HRT + HSTEP).
    OPT_TBOT=2 (Noah lower boundary at ZBOT), OPT_STC=1."""
    zbotsno = p.zbot - snowh          # ZBOT measured from snow surface
    act = _active(isnow)
    is_top = _stack_j() == (isnow[None] + 1)

    zs_m1 = jnp.concatenate([jnp.zeros_like(zsnso[:1]), zsnso[:-1]], axis=0)
    zs_p1 = jnp.concatenate([zsnso[1:], zsnso[-1:]], axis=0)
    stc_p1 = jnp.concatenate([stc[1:], stc[-1:]], axis=0)
    df_m1 = jnp.concatenate([df[:1], df[:-1]], axis=0)

    denom = jnp.where(is_top, -zsnso * hcpct, (zs_m1 - zsnso) * hcpct)
    temp1 = jnp.where(is_top, -zs_p1, zs_m1 - zs_p1)
    ddz = 2.0 / jnp.where(jnp.abs(temp1) < MPE, MPE, temp1)
    dtsdz = 2.0 * (stc - stc_p1) / jnp.where(jnp.abs(temp1) < MPE,
                                             MPE, temp1)
    # bottom row (soil layer NSOIL)
    dtsdz_bot = (stc[-1] - tbot) / (0.5 * (zsnso[-2] + zsnso[-1]) - zbotsno)
    botflx = -df[-1] * dtsdz_bot
    dtsdz = dtsdz.at[-1].set(dtsdz_bot)
    dtsdz_m1 = jnp.concatenate([dtsdz[:1], dtsdz[:-1]], axis=0)
    ddz_m1 = jnp.concatenate([ddz[:1], ddz[:-1]], axis=0)

    eflux = jnp.where(is_top, df * dtsdz - ssoil[None],
                      df * dtsdz - df_m1 * dtsdz_m1)
    eflux = eflux.at[-1].set(
        jnp.where(is_top[-1], eflux[-1],
                  -botflx - df_m1[-1] * dtsdz_m1[-1]))

    ai = jnp.where(is_top, 0.0, -df_m1 * ddz_m1 / denom)
    ci = -df * ddz / denom
    ci = ci.at[-1].set(0.0)
    bi = jnp.where(is_top, -ci, -(ai + ci))
    rhsts = eflux / (-denom)

    # HSTEP: (1 + bi*dt) dT ... = rhs*dt
    a = ai * dt
    b = 1.0 + bi * dt
    c = ci * dt
    r = rhsts * dt
    dstc = _thomas_stack(a, b, c, r, act)
    return jnp.where(act, stc + dstc, stc)


# ==========================================================================
# melting/freezing of snow & soil (PHASECHANGE, :5543-5756; OPT_FRZ=1)
# ==========================================================================

def phasechange(p, isnow, dt, fact, dzsnso, stc, snice, snliq, sneqv,
                snowh, smc, sh2o):
    """Energy-residual phase change with NY06 supercooled liquid water.
    Returns updated (stc, snice, snliq, sneqv, snowh, smc, sh2o, qmelt,
    imelt, ponding)."""
    act = _active(isnow)
    j_ax = _stack_j()
    is_snow = j_ax <= 0

    mice = jnp.concatenate([snice, (smc - sh2o) * dzsnso[NSNOW:] * 1000.0],
                           axis=0)
    mliq = jnp.concatenate([snliq, sh2o * dzsnso[NSNOW:] * 1000.0], axis=0)
    wice0 = mice
    wliq0 = mliq
    wmass0 = mice + mliq

    # NY06 supercooled water (soil only)
    smp = HFUS * (TFRZ - stc[NSNOW:]) / (GRAV * stc[NSNOW:])
    supercool_soil = (p.smcmax[None]
                      * (smp / p.psisat[None]) ** (-1.0 / p.bexp[None]))
    supercool_soil = jnp.where(stc[NSNOW:] < TFRZ,
                               supercool_soil * dzsnso[NSNOW:] * 1000.0,
                               0.0)
    supercool = jnp.concatenate(
        [jnp.zeros_like(snice), supercool_soil], axis=0)

    imelt = jnp.zeros_like(stc, jnp.int32)
    imelt = jnp.where(act & (mice > 0.0) & (stc >= TFRZ), 1, imelt)
    imelt = jnp.where(act & (mliq > supercool) & (stc < TFRZ), 2, imelt)
    # layerless snowpack melts through the first soil layer (:5626-5631)
    thin = (isnow == 0) & (sneqv > 0.0)
    first_soil = j_ax == 1
    imelt = jnp.where(first_soil & thin[None] & (stc >= TFRZ), 1, imelt)

    melting = imelt > 0
    hm = jnp.where(melting, (stc - TFRZ) / fact, 0.0)
    stc = jnp.where(melting, TFRZ, stc)
    bad = ((imelt == 1) & (hm < 0.0)) | ((imelt == 2) & (hm > 0.0))
    hm = jnp.where(bad, 0.0, hm)
    imelt = jnp.where(bad, 0, imelt)
    xm = hm * dt / HFUS

    # bulk (layerless) snowpack melt (:5652-5669)
    qmelt = jnp.zeros_like(sneqv)
    ponding = jnp.zeros_like(sneqv)
    do_thin = thin & (xm[NSNOW] > 0.0)
    temp1 = sneqv
    sneqv_n = jnp.maximum(0.0, temp1 - xm[NSNOW])
    propor = sneqv_n / jnp.maximum(temp1, MPE)
    snowh_n = jnp.maximum(0.0, propor * snowh)
    snowh_n = jnp.minimum(jnp.maximum(snowh_n, sneqv_n / 500.0),
                          sneqv_n / 50.0)
    heatr = hm[NSNOW] - HFUS * (temp1 - sneqv_n) / dt
    xm1 = jnp.where(heatr > 0.0, heatr * dt / HFUS, 0.0)
    hm1 = jnp.where(heatr > 0.0, heatr, 0.0)
    qmelt = jnp.where(do_thin, jnp.maximum(0.0, temp1 - sneqv_n) / dt,
                      qmelt)
    ponding = jnp.where(do_thin, temp1 - sneqv_n, ponding)
    sneqv = jnp.where(do_thin, sneqv_n, sneqv)
    snowh = jnp.where(do_thin, snowh_n, snowh)
    hm = hm.at[NSNOW].set(jnp.where(do_thin, hm1, hm[NSNOW]))
    xm = xm.at[NSNOW].set(jnp.where(do_thin, xm1, xm[NSNOW]))

    # layer-by-layer phase change; sequential because a fully-melted snow
    # layer passes residual heat to the layer below (BARLAGE, :5700-5707)
    for m in range(NSS):
        j = m - (NSNOW - 1)
        do = act[m] & (imelt[m] > 0) & (jnp.abs(hm[m]) > 0.0)
        mice_m = mice[m]
        melt_pos = xm[m] > 0.0
        mice_pos = jnp.maximum(0.0, wice0[m] - xm[m])
        if j <= 0:
            mice_neg = jnp.minimum(wmass0[m], wice0[m] - xm[m])
        else:
            mice_neg = jnp.where(
                wmass0[m] < supercool[m], 0.0,
                jnp.maximum(
                    jnp.minimum(wmass0[m] - supercool[m],
                                wice0[m] - xm[m]), 0.0))
        mice_new = jnp.where(melt_pos, mice_pos,
                             jnp.where(xm[m] < 0.0, mice_neg, mice_m))
        heatr = hm[m] - HFUS * (wice0[m] - mice_new) / dt
        mliq_new = jnp.maximum(0.0, wmass0[m] - mice_new)
        has_res = jnp.abs(heatr) > 0.0
        stc_m = jnp.where(do & has_res, stc[m] + fact[m] * heatr, stc[m])
        if j <= 0:
            both = (mliq_new * mice_new) > 0.0
            gone = mice_new == 0.0
            stc_m = jnp.where(do & has_res & both, TFRZ, stc_m)
            stc_m = jnp.where(do & has_res & gone, TFRZ, stc_m)
            # pass the residual down one layer
            pass_heat = do & has_res & gone
            hm = hm.at[m + 1].set(
                jnp.where(pass_heat, hm[m + 1] + heatr, hm[m + 1]))
            xm = xm.at[m + 1].set(
                jnp.where(pass_heat, hm[m + 1] * dt / HFUS, xm[m + 1]))
            qmelt = qmelt + jnp.where(
                do, jnp.maximum(0.0, wice0[m] - mice_new) / dt, 0.0) \
                * (1.0 if j < 1 else 0.0)
        stc = stc.at[m].set(stc_m)
        mice = mice.at[m].set(jnp.where(do, mice_new, mice[m]))
        mliq = mliq.at[m].set(jnp.where(do, mliq_new, mliq[m]))

    snice = mice[:NSNOW]
    snliq = mliq[:NSNOW]
    sh2o = mliq[NSNOW:] / (1000.0 * dzsnso[NSNOW:])
    smc = (mliq[NSNOW:] + mice[NSNOW:]) / (1000.0 * dzsnso[NSNOW:])
    return stc, snice, snliq, sneqv, snowh, smc, sh2o, qmelt, imelt, ponding


# ==========================================================================
# energy driver (ENERGY, :1695-2334)
# ==========================================================================

def energy(p, vegtype, isnow, dt, rhoair, sfcprs, qair, sfctmp, thair,
           lwdn, uu, vv, zref, solad, solai, cosz, igs, eair, tbot,
           zsnso, zsoil, elai, esai, fwet, foln, fveg, pahv, pahg, pahb,
           qsnow, dzsnso, lat, canliq, canice, tv, tg, stc, snowh, eah,
           tah, sneqvo, sneqv, sh2o, smc, snice, snliq, albold, cm, ch,
           q2, tauss, psfc):
    """Energy budget: thermal properties, radiation, canopy + bare-ground
    flux solutions, snow/soil diffusion, phase change. IST=1, ICE=0."""
    ur = jnp.maximum(jnp.sqrt(uu ** 2 + vv ** 2), 1.0)
    vai = elai + esai
    veg = vai > 0.0

    # snow cover fraction (:1964-1969, Niu & Yang 2007)
    bdsno = sneqv / jnp.maximum(snowh, MPE)
    fmelt = (bdsno / 100.0) ** p.mfsno
    fsno = jnp.where(snowh > 0.0,
                     jnp.tanh(snowh / (p.scffac * fmelt)), 0.0)

    z0 = 0.002
    z0mg = z0 * (1.0 - fsno) + fsno * p.z0sno
    zpdg = snowh
    z0m = jnp.where(veg, p.z0mvt, z0mg)
    zpd = jnp.where(veg, jnp.maximum(0.65 * p.hvt, snowh), zpdg)
    zlvl = jnp.maximum(zpd, p.hvt) + zref
    zlvl = jnp.where(zpdg >= zlvl, zpdg + zref, zlvl)

    df, hcpct, snicev, snliqv, epore, fact = thermoprop(
        p, isnow, dzsnso, dt, snowh, snice, snliq, smc, sh2o)

    rad = radiation(p, dt, cosz, elai, esai, tg, tv, fsno, qsnow, fwet,
                    smc[0], sneqvo, sneqv, fveg, tauss, vegtype,
                    solad, solai)

    emv = 1.0 - jnp.exp(-(elai + esai) / 1.0)
    emg = float(p.eg[0]) * (1.0 - fsno) + p.snow_emis * fsno

    # soil moisture transpiration factor (OPT_BTR=1 Noah, :2036-2053)
    nroot_mask = (jnp.arange(NSOIL)[:, None, None]
                  < p.nroot[None])
    zroot = -take_level(
        jnp.broadcast_to(zsoil[:, None, None],
                         (NSOIL,) + p.nroot.shape),
        jnp.clip(p.nroot, 1, NSOIL) - 1)
    gx = jnp.clip((sh2o - p.smcwlt[None])
                  / jnp.maximum(p.smcref[None] - p.smcwlt[None], MPE),
                  0.0, 1.0)
    btrani = jnp.maximum(MPE, dzsnso[NSNOW:] / zroot[None] * gx)
    btrani = jnp.where(nroot_mask, btrani, 0.0)
    btran = jnp.maximum(MPE, jnp.sum(btrani, axis=0))
    btrani = btrani / btran

    # surface resistance, Sakaguchi & Zeng 2009 (OPT_RSF=1, :2060-2081)
    bevap = jnp.maximum(0.0, sh2o[0] / p.smcmax)
    l_rsurf = (-zsoil[0]) * (
        jnp.exp((1.0 - jnp.minimum(1.0, sh2o[0] / p.smcmax))
                ** p.rsurf_exp) - 1.0) / (2.71828 - 1.0)
    d_rsurf = 2.2e-5 * p.smcmax * p.smcmax \
        * (1.0 - p.smcwlt / p.smcmax) ** (2.0 + 3.0 / p.bexp)
    rsurf = l_rsurf / d_rsurf
    rsurf = jnp.where((sh2o[0] < 0.01) & (snowh == 0.0), 1e6, rsurf)
    psi = -p.psisat * (jnp.maximum(0.01, sh2o[0])
                       / p.smcmax) ** (-p.bexp)
    rhsur = fsno + (1.0 - fsno) * jnp.exp(psi * GRAV / (RW * tg))

    frozen_canopy = tv <= TFRZ
    latheav = jnp.where(frozen_canopy, HSUB, HVAP)
    gammav = CPAIR * sfcprs / (0.622 * latheav)
    frozen_ground = tg <= TFRZ
    latheag = jnp.where(frozen_ground, HSUB, HVAP)
    gammag = CPAIR * sfcprs / (0.622 * latheag)

    vf = vege_flux(
        p, isnow, dt, rad.sav, rad.sag, lwdn, ur, uu, vv, sfctmp, thair,
        qair, eair, rhoair, snowh, vai, gammav, gammag, fwet, rad.laisun,
        rad.laisha, dzsnso, zlvl, zpd, z0m, fveg, z0mg, canliq, canice,
        stc, df, rsurf, latheav, latheag, rad.parsun, rad.parsha, igs,
        foln, p.co2 * sfcprs, p.o2 * sfcprs, btran, sfcprs, rhsur, q2,
        pahv, pahg, eah, tah, tv, tg, cm, ch, fsno, emv, emg)
    bf = bare_flux(
        p, isnow, dt, rad.sag, lwdn, ur, uu, vv, sfctmp, thair, qair,
        eair, rhoair, snowh, dzsnso, zlvl, zpdg, z0mg, fsno, emg, stc,
        df, rsurf, latheag, gammag, rhsur, q2, pahb, tg, cm, ch, sfcprs)

    vegcell = veg & (fveg > 0.0)
    w = jnp.where(vegcell, fveg, 0.0)
    tgv, tgb = vf.tg, bf.tgb
    taux = w * vf.tauxv + (1.0 - w) * bf.tauxb
    tauy = w * vf.tauyv + (1.0 - w) * bf.tauyb
    fira = jnp.where(vegcell, w * vf.irg + (1.0 - w) * bf.irb + vf.irc,
                     bf.irb)
    fsh = jnp.where(vegcell, w * vf.shg + (1.0 - w) * bf.shb + vf.shc,
                    bf.shb)
    fgev = jnp.where(vegcell, w * vf.evg + (1.0 - w) * bf.evb, bf.evb)
    ssoil = jnp.where(vegcell, w * vf.gh + (1.0 - w) * bf.ghb, bf.ghb)
    fcev = jnp.where(vegcell, vf.evc, 0.0)
    fctr = jnp.where(vegcell, vf.tr, 0.0)
    pah = jnp.where(vegcell, w * pahg + (1.0 - w) * pahb + pahv, pahb)
    tg = jnp.where(vegcell, w * tgv + (1.0 - w) * tgb, tgb)
    t2m = jnp.where(vegcell, w * vf.t2mv + (1.0 - w) * bf.t2mb, bf.t2mb)
    ts = jnp.where(vegcell, w * vf.tv + (1.0 - w) * tgb, tg)
    cm = jnp.where(vegcell, w * vf.cm + (1.0 - w) * bf.cm, bf.cm)
    ch = jnp.where(vegcell, w * vf.ch + (1.0 - w) * bf.ch, bf.ch)
    q1 = jnp.where(vegcell,
                   w * (vf.eah * 0.622 / (sfcprs - 0.378 * vf.eah))
                   + (1.0 - w) * bf.qsfc, bf.qsfc)
    q2e = jnp.where(vegcell, w * vf.q2v + (1.0 - w) * bf.q2b, bf.q2b)
    z0wrf = jnp.where(vegcell, z0m, z0mg)
    tv = jnp.where(vegcell, vf.tv, tg)
    eah = jnp.where(vegcell, vf.eah, eah)
    tah = jnp.where(vegcell, vf.tah, tah)
    qsfc = jnp.where(vegcell, vf.qsfc, bf.qsfc)
    rssun = jnp.where(vegcell, vf.rssun, 0.0)
    rssha = jnp.where(vegcell, vf.rssha, 0.0)

    fire = lwdn + fira
    emissi = fveg * (emg * (1.0 - emv) + emv
                     + emv * (1.0 - emv) * (1.0 - emg)) \
        + (1.0 - fveg) * emg
    trad = (jnp.maximum(fire - (1.0 - emissi) * lwdn, 1.0)
            / (emissi * SB)) ** 0.25
    apar = rad.parsun * rad.laisun + rad.parsha * rad.laisha
    psn = jnp.where(vegcell,
                    vf.psnsun * rad.laisun + vf.psnsha * rad.laisha, 0.0)

    stc = tsnosoi(p, isnow, tbot, zsnso, ssoil, df, hcpct, dt, snowh,
                  dzsnso, stc)

    (stc, snice, snliq, sneqv, snowh, smc, sh2o, qmelt, imelt,
     ponding) = phasechange(p, isnow, dt, fact, dzsnso, stc, snice,
                            snliq, sneqv, snowh, smc, sh2o)

    return SimpleNamespace(
        tv=tv, tg=tg, stc=stc, snowh=snowh, eah=eah, tah=tah,
        sneqv=sneqv, sh2o=sh2o, smc=smc, snice=snice, snliq=snliq,
        cm=cm, ch=ch, tauss=rad.tauss, qsfc=qsfc, imelt=imelt,
        snicev=snicev, snliqv=snliqv, epore=epore, t2m=t2m, fsno=fsno,
        sav=rad.sav, sag=rad.sag, qmelt=qmelt, fsa=rad.fsa, fsr=rad.fsr,
        taux=taux, tauy=tauy, fira=fira, fsh=fsh, fcev=fcev, fgev=fgev,
        fctr=fctr, trad=trad, psn=psn, apar=apar, ssoil=ssoil,
        btrani=btrani, btran=btran, ponding=ponding, ts=ts,
        latheav=latheav, latheag=latheag, frozen_canopy=frozen_canopy,
        frozen_ground=frozen_ground, t2mv=vf.t2mv, t2mb=bf.t2mb,
        q2v=vf.q2v, q2b=bf.q2b, q2e=q2e, q1=q1, emissi=emissi,
        z0wrf=z0wrf, fsrv=rad.fsrv, fsrg=rad.fsrg, rssun=rssun,
        rssha=rssha, albsnd=rad.albsnd, albsni=rad.albsni,
        bgap=rad.bgap, wgap=rad.wgap, tgv=tgv, tgb=tgb, chv=vf.ch,
        chb=bf.ch, shg=vf.shg, shc=vf.shc, shb=bf.shb, evg=vf.evg,
        evb=bf.evb, ghv=vf.gh, ghb=bf.ghb, irg=vf.irg, irc=vf.irc,
        irb=bf.irb, tr=vf.tr, evc=vf.evc, chleaf=vf.chleaf,
        chuc=vf.chuc, chv2=vf.chv2, chb2=bf.chb2, pah=pah, laisun=rad.laisun,
        laisha=rad.laisha, rb=vf.rb, fveg_out=fveg)


# ==========================================================================
# canopy water (CANWATER, :6168-6298)
# ==========================================================================

def canwater(p, dt, fcev, fctr, elai, esai, bdfall, frozen_canopy,
             canliq, canice, tv):
    """Canopy hydrology + canopy snow melt/refreeze."""
    maxliq = p.ch2op * (elai + esai)
    fc = frozen_canopy
    etran = jnp.where(fc, jnp.maximum(fctr / HSUB, 0.0),
                      jnp.maximum(fctr / HVAP, 0.0))
    qevac = jnp.where(fc, 0.0, jnp.maximum(fcev / HVAP, 0.0))
    qdewc = jnp.where(fc, 0.0, jnp.abs(jnp.minimum(fcev / HVAP, 0.0)))
    qsubc = jnp.where(fc, jnp.maximum(fcev / HSUB, 0.0), 0.0)
    qfroc = jnp.where(fc, jnp.abs(jnp.minimum(fcev / HSUB, 0.0)), 0.0)

    qevac = jnp.minimum(canliq / dt, qevac)
    canliq = jnp.maximum(0.0, canliq + (qdewc - qevac) * dt)
    canliq = jnp.where(canliq <= 1e-6, 0.0, canliq)
    maxsno = 6.6 * (0.27 + 46.0 / bdfall) * (elai + esai)
    qsubc = jnp.minimum(canice / dt, qsubc)
    canice = jnp.maximum(0.0, canice + (qfroc - qsubc) * dt)
    canice = jnp.where(canice <= 1e-6, 0.0, canice)

    fwet = jnp.where(canice > 0.0,
                     canice / jnp.maximum(maxsno, 1e-6),
                     canliq / jnp.maximum(maxliq, 1e-6))
    fwet = jnp.minimum(fwet, 1.0) ** 0.667

    melt = (canice > 1e-6) & (tv > TFRZ)
    qmeltc = jnp.where(melt, jnp.minimum(
        canice / dt, (tv - TFRZ) * CICE * canice / DENICE / (dt * HFUS)),
        0.0)
    canice = jnp.maximum(0.0, canice - qmeltc * dt)
    canliq = jnp.maximum(0.0, canliq + qmeltc * dt)
    tv = jnp.where(melt, fwet * TFRZ + (1.0 - fwet) * tv, tv)
    frz = (canliq > 1e-6) & (tv < TFRZ)
    qfrzc = jnp.where(frz, jnp.minimum(
        canliq / dt, (TFRZ - tv) * CWAT * canliq / DENH2O / (dt * HFUS)),
        0.0)
    canliq = jnp.maximum(0.0, canliq - qfrzc * dt)
    canice = jnp.maximum(0.0, canice + qfrzc * dt)
    tv = jnp.where(frz, fwet * TFRZ + (1.0 - fwet) * tv, tv)

    cmc = canliq + canice
    ecan = qevac + qsubc - qdewc - qfroc
    return canliq, canice, tv, cmc, ecan, etran, fwet


# ==========================================================================
# snow hydrology (SNOWWATER chain, :6300-7126)
# ==========================================================================

def _shift_down_nmp(arrs, shift_mask):
    out = []
    for a in arrs:
        rolled = jnp.concatenate([a[:1], a[:-1]], axis=0)
        out.append(jnp.where(shift_mask, rolled, a))
    return out


def _combo_nmp(dz1, liq1, ice1, t1, dz2, liq2, ice2, t2):
    """Enthalpy merge of two snow elements (COMBO, :6819-6871)."""
    dzc = dz1 + dz2
    wicec = ice1 + ice2
    wliqc = liq1 + liq2
    h = (CICE * ice1 + CWAT * liq1) * (t1 - TFRZ) + HFUS * liq1
    h2 = (CICE * ice2 + CWAT * liq2) * (t2 - TFRZ) + HFUS * liq2
    hc = h + h2
    cpc = jnp.maximum(CICE * wicec + CWAT * wliqc, MPE)
    tc = jnp.where(hc < 0.0, TFRZ + hc / cpc,
                   jnp.where(hc <= HFUS * wliqc, TFRZ,
                             TFRZ + (hc - HFUS * wliqc) / cpc))
    return dzc, wliqc, wicec, tc


def snowfall_acc(p, dt, qsnow, snowhin, sfctmp, isnow, snowh, sneqv,
                 dzsnso, stc, snice, snliq, new_layer_thresh=0.025):
    """Snow accumulation and new-layer initiation (SNOWFALL,
    :6433-6501). dzsnso here is the POSITIVE thickness stack."""
    bulk = (isnow == 0) & (qsnow > 0.0)
    snowh = jnp.where(bulk, snowh + snowhin * dt, snowh)
    sneqv = jnp.where(bulk, sneqv + qsnow * dt, sneqv)

    newnode = bulk & (snowh >= new_layer_thresh)
    m0 = NSNOW - 1
    isnow = jnp.where(newnode, -1, isnow)
    dzsnso = dzsnso.at[m0].set(jnp.where(newnode, snowh, dzsnso[m0]))
    snowh = jnp.where(newnode, 0.0, snowh)
    stc = stc.at[m0].set(jnp.where(newnode,
                                   jnp.minimum(273.16, sfctmp), stc[m0]))
    snice = snice.at[m0].set(jnp.where(newnode, sneqv, snice[m0]))
    snliq = snliq.at[m0].set(jnp.where(newnode, 0.0, snliq[m0]))

    accrete = (isnow < 0) & ~newnode & (qsnow > 0.0)
    mtop = isnow + NSNOW   # stack index of layer isnow+1
    ice_t = _gather_m(snice, mtop)
    dz_t = _gather_m(dzsnso, mtop)
    snice = _scatter_m(snice, mtop, ice_t + qsnow * dt, accrete)
    dzsnso = _scatter_m(dzsnso, mtop, dz_t + snowhin * dt, accrete)
    return isnow, snowh, sneqv, dzsnso, stc, snice, snliq


def compact_snow(p, dt, stc, snice, snliq, imelt, ficeold, isnow, dzsnso):
    """Snow compaction (COMPACT, :6873-6977); positive-thickness stack."""
    c2, c3, c4, c5 = 21.0e-3, 2.5e-6, 0.04, 2.0
    dm, eta0 = 100.0, 0.8e6
    smask = _snow_mask(isnow)[:NSNOW]
    burden = jnp.zeros_like(isnow, jnp.float32)
    for m in range(NSNOW):
        act = smask[m]
        wx = snice[m] + snliq[m]
        fice = snice[m] / jnp.maximum(wx, MPE)
        dzm = jnp.maximum(dzsnso[m], MPE)
        void = 1.0 - (snice[m] / DENICE + snliq[m] / DENH2O) / dzm
        do = act & (void > 0.001) & (snice[m] > 0.1)
        bi = snice[m] / dzm
        td = jnp.maximum(0.0, TFRZ - stc[m])
        ddz1 = -c3 * jnp.exp(-c4 * td)
        ddz1 = jnp.where(bi > dm, ddz1 * jnp.exp(-46.0e-3 * (bi - dm)),
                         ddz1)
        ddz1 = jnp.where(snliq[m] > 0.01 * dzm, ddz1 * c5, ddz1)
        ddz2 = -(burden + 0.5 * wx) * jnp.exp(
            -0.08 * td - c2 * bi) / eta0
        fio = jnp.maximum(1e-6, ficeold[m])
        ddz3 = jnp.where(imelt[m] == 1,
                         -jnp.maximum(0.0, (fio - fice) / fio) / dt, 0.0)
        pdzdtc = jnp.maximum(-0.5, (ddz1 + ddz2 + ddz3) * dt)
        newdz = jnp.maximum(dzsnso[m] * (1.0 + pdzdtc),
                            snice[m] / DENICE + snliq[m] / DENH2O)
        dzsnso = dzsnso.at[m].set(jnp.where(do, newdz, dzsnso[m]))
        burden = burden + jnp.where(act, wx, 0.0)
    return dzsnso


def combine_snow(p, isnow, sh2o, sice, stc, snice, snliq, dzsnso, snowh,
                 sneqv, dzsnso_soil1, dzmin_vals=(0.025, 0.025, 0.1),
                 gone_thresh=0.025, glacier=False):
    """Merge thin/ice-poor snow layers (COMBINE, :6503-6689); positive
    thickness stack. dzmin = [0.025, 0.025, 0.1]."""
    ny, nx = isnow.shape
    m_ax = jnp.arange(NSNOW, dtype=jnp.int32)[:, None, None]
    j_ax3 = m_ax - (NSNOW - 1)
    ponding1 = jnp.zeros_like(sneqv)
    ponding2 = jnp.zeros_like(sneqv)

    # pass 1: remove ice-poor layers
    isnow_old = isnow
    for j in range(-NSNOW + 1, 1):
        m = j + NSNOW - 1
        has = (j >= isnow_old + 1) & (j >= isnow + 1)
        low = has & (snice[m] <= 0.1)
        if j != 0:
            snliq = snliq.at[m + 1].add(jnp.where(low, snliq[m], 0.0))
            snice = snice.at[m + 1].add(jnp.where(low, snice[m], 0.0))
            dzsnso = dzsnso.at[m + 1].add(jnp.where(low, dzsnso[m], 0.0))
        else:
            multi = isnow_old < -1
            up = low & multi
            snliq = snliq.at[m - 1].add(jnp.where(up, snliq[m], 0.0))
            snice = snice.at[m - 1].add(jnp.where(up, snice[m], 0.0))
            dzsnso = dzsnso.at[m - 1].add(jnp.where(up, dzsnso[m], 0.0))
            solo = low & ~multi
            pos = (snice[m] >= 0.0) | glacier
            ponding1 = jnp.where(
                solo & pos,
                (ponding1 + snliq[m]) if glacier else snliq[m], ponding1)
            sneqv = jnp.where(solo & pos, snice[m], sneqv)
            snowh = jnp.where(solo & pos, dzsnso[m], snowh)
            p1n = snliq[m] + snice[m]
            sice = sice.at[0].set(jnp.where(
                solo & ~pos & (p1n < 0.0),
                jnp.maximum(0.0, sice[0] + p1n / (dzsnso_soil1 * 1000.0)),
                sice[0]))
            ponding1 = jnp.where(solo & ~pos, jnp.maximum(p1n, 0.0),
                                 ponding1)
            sneqv = jnp.where(solo & ~pos, 0.0, sneqv)
            snowh = jnp.where(solo & ~pos, 0.0, snowh)
            snliq = snliq.at[m].set(jnp.where(solo, 0.0, snliq[m]))
            snice = snice.at[m].set(jnp.where(solo, 0.0, snice[m]))
            dzsnso = dzsnso.at[m].set(jnp.where(solo, 0.0, dzsnso[m]))
        shift = low[None] & (j_ax3 <= j) & (j_ax3 >= isnow[None] + 2)
        stc_s = stc[:NSNOW]
        stc_s, snliq, snice, dzsnso = _shift_down_nmp(
            (stc_s, snliq, snice, dzsnso), shift)
        stc = stc.at[:NSNOW].set(stc_s)
        isnow = jnp.where(low, isnow + 1, isnow)

    neg_ice = sice[0] < 0.0
    sh2o = sh2o.at[0].set(jnp.where(neg_ice, sh2o[0] + sice[0], sh2o[0]))
    sice = sice.at[0].set(jnp.where(neg_ice, 0.0, sice[0]))

    multi = isnow < 0
    smask = _snow_mask(isnow)[:NSNOW]
    sneqv_s = jnp.sum(jnp.where(smask, snice + snliq, 0.0), axis=0)
    snowh_s = jnp.sum(jnp.where(smask, dzsnso, 0.0), axis=0)
    zwice = jnp.sum(jnp.where(smask, snice, 0.0), axis=0)
    zwliq = jnp.sum(jnp.where(smask, snliq, 0.0), axis=0)
    sneqv = jnp.where(multi, sneqv_s, sneqv)
    snowh = jnp.where(multi, snowh_s, snowh)

    gone = multi & (snowh < gone_thresh)
    isnow = jnp.where(gone, 0, isnow)
    sneqv = jnp.where(gone, zwice, sneqv)
    ponding2 = jnp.where(gone, zwliq, ponding2)
    snowh = jnp.where(gone & (sneqv <= 0.0), 0.0, snowh)

    # pass 2: combine below-minimum layers
    dzmin = jnp.asarray(list(dzmin_vals), jnp.float32)
    isnow_old2 = isnow
    mssi = jnp.ones_like(isnow)
    for i in range(-NSNOW + 1, 1):
        mi = i + NSNOW - 1
        act = (isnow < -1) & (i >= isnow_old2 + 1)
        thin = dzsnso[mi] < dzmin[jnp.clip(mssi - 1, 0, NSNOW - 1)]
        do = act & thin
        is_top = i == (isnow + 1)
        is_bot = i == 0
        dz_m1 = dzsnso[max(mi - 1, 0)]
        dz_p1 = dzsnso[min(mi + 1, NSNOW - 1)]
        neibor = jnp.where(
            is_top, i + 1,
            jnp.where(is_bot, i - 1,
                      jnp.where(dz_m1 + dzsnso[mi] < dz_p1 + dzsnso[mi],
                                i - 1, i + 1))).astype(jnp.int32)
        jidx = jnp.maximum(i, neibor) + NSNOW - 1
        lidx = jnp.minimum(i, neibor) + NSNOW - 1
        stc_s = stc[:NSNOW]
        dzc, liqc, icec, tc = _combo_nmp(
            _gather_m(dzsnso, jidx), _gather_m(snliq, jidx),
            _gather_m(snice, jidx), _gather_m(stc_s, jidx),
            _gather_m(dzsnso, lidx), _gather_m(snliq, lidx),
            _gather_m(snice, lidx), _gather_m(stc_s, lidx))
        dzsnso = _scatter_m(dzsnso, jidx, dzc, do)
        snliq = _scatter_m(snliq, jidx, liqc, do)
        snice = _scatter_m(snice, jidx, icec, do)
        stc_s = _scatter_m(stc_s, jidx, tc, do)
        shift = do[None] & (m_ax <= jidx[None] - 1) \
            & (j_ax3 >= isnow[None] + 2)
        stc_s, snliq, snice, dzsnso = _shift_down_nmp(
            (stc_s, snliq, snice, dzsnso), shift)
        stc = stc.at[:NSNOW].set(stc_s)
        isnow = jnp.where(do, isnow + 1, isnow)
        mssi = jnp.where(act & ~thin, mssi + 1, mssi)

    return (isnow, sh2o, sice, stc, snice, snliq, dzsnso, snowh, sneqv,
            ponding1, ponding2)


def divide_snow(p, isnow, stc, snice, snliq, dzsnso, split2_thresh=0.20):
    """Subdivide thick layers (DIVIDE, :6691-6817); NoahMP's 3-layer
    cascade in top-down compressed coordinates."""
    msno = -isnow
    k_ax = jnp.arange(1, NSNOW + 1, dtype=jnp.int32)[:, None, None]
    gidx = k_ax + isnow[None] + (NSNOW - 1)

    def gath(a):
        return take_level(a, gidx)
    stc_s = stc[:NSNOW]
    dz, swice, swliq, tsno = (gath(dzsnso), gath(snice), gath(snliq),
                              gath(stc_s))

    c = (msno == 1) & (dz[0] > 0.05)
    half = 0.5 * dz[0]
    dz = dz.at[1].set(jnp.where(c, half, dz[1]))
    dz = dz.at[0].set(jnp.where(c, half, dz[0]))
    swice = swice.at[1].set(jnp.where(c, 0.5 * swice[0], swice[1]))
    swice = swice.at[0].set(jnp.where(c, 0.5 * swice[0], swice[0]))
    swliq = swliq.at[1].set(jnp.where(c, 0.5 * swliq[0], swliq[1]))
    swliq = swliq.at[0].set(jnp.where(c, 0.5 * swliq[0], swliq[0]))
    tsno = tsno.at[1].set(jnp.where(c, tsno[0], tsno[1]))
    msno = jnp.where(c, 2, msno)

    # trim layer 1 to 0.05 m, merge excess into layer 2
    c1 = (msno > 1) & (dz[0] > 0.05)
    drr = dz[0] - 0.05
    propor = drr / jnp.maximum(dz[0], MPE)
    zwice = propor * swice[0]
    zwliq = propor * swliq[0]
    keep = 0.05 / jnp.maximum(dz[0], MPE)
    dzc, liqc, icec, tc = _combo_nmp(dz[1], swliq[1], swice[1], tsno[1],
                                     drr, zwliq, zwice, tsno[0])
    swice = swice.at[0].set(jnp.where(c1, keep * swice[0], swice[0]))
    swliq = swliq.at[0].set(jnp.where(c1, keep * swliq[0], swliq[0]))
    dz = dz.at[0].set(jnp.where(c1, 0.05, dz[0]))
    dz = dz.at[1].set(jnp.where(c1, dzc, dz[1]))
    swliq = swliq.at[1].set(jnp.where(c1, liqc, swliq[1]))
    swice = swice.at[1].set(jnp.where(c1, icec, swice[1]))
    tsno = tsno.at[1].set(jnp.where(c1, tc, tsno[1]))
    # split layer 2 with temperature gradient (:6769-6783)
    c2 = c1 & (msno <= 2) & (dz[1] > split2_thresh)
    dtdz = (tsno[0] - tsno[1]) / jnp.maximum((dz[0] + dz[1]) / 2.0, MPE)
    half2 = 0.5 * dz[1]
    t3 = tsno[1] - dtdz * half2 / 2.0
    warm3 = t3 >= TFRZ
    dz = dz.at[2].set(jnp.where(c2, half2, dz[2]))
    swice = swice.at[2].set(jnp.where(c2, 0.5 * swice[1], swice[2]))
    swliq = swliq.at[2].set(jnp.where(c2, 0.5 * swliq[1], swliq[2]))
    tsno = tsno.at[2].set(jnp.where(c2, jnp.where(warm3, tsno[1], t3),
                                    tsno[2]))
    tsno = tsno.at[1].set(jnp.where(c2 & ~warm3,
                                    tsno[1] + dtdz * half2 / 2.0,
                                    tsno[1]))
    dz = dz.at[1].set(jnp.where(c2, half2, dz[1]))
    swice = swice.at[1].set(jnp.where(c2, 0.5 * swice[1], swice[1]))
    swliq = swliq.at[1].set(jnp.where(c2, 0.5 * swliq[1], swliq[1]))
    msno = jnp.where(c2, 3, msno)

    # trim layer 2 to 0.2 m, excess into layer 3
    c3 = (msno > 2) & (dz[1] > 0.2)
    drr = dz[1] - 0.2
    propor = drr / jnp.maximum(dz[1], MPE)
    zwice = propor * swice[1]
    zwliq = propor * swliq[1]
    keep = 0.2 / jnp.maximum(dz[1], MPE)
    dzc, liqc, icec, tc = _combo_nmp(dz[2], swliq[2], swice[2], tsno[2],
                                     drr, zwliq, zwice, tsno[1])
    swice = swice.at[1].set(jnp.where(c3, keep * swice[1], swice[1]))
    swliq = swliq.at[1].set(jnp.where(c3, keep * swliq[1], swliq[1]))
    dz = dz.at[1].set(jnp.where(c3, 0.2, dz[1]))
    dz = dz.at[2].set(jnp.where(c3, dzc, dz[2]))
    swliq = swliq.at[2].set(jnp.where(c3, liqc, swliq[2]))
    swice = swice.at[2].set(jnp.where(c3, icec, swice[2]))
    tsno = tsno.at[2].set(jnp.where(c3, tc, tsno[2]))

    isnow = -msno
    m_ax = jnp.arange(NSNOW, dtype=jnp.int32)[:, None, None]
    j_ax3 = m_ax - (NSNOW - 1)
    cidx = jnp.clip(j_ax3 - isnow[None] - 1, 0, NSNOW - 1)
    smask3 = j_ax3 >= isnow[None] + 1

    def scat(stack, comp):
        return jnp.where(smask3, take_level(comp, cidx), stack)
    dzsnso = scat(dzsnso, dz)
    snice = scat(snice, swice)
    snliq = scat(snliq, swliq)
    stc = stc.at[:NSNOW].set(scat(stc[:NSNOW], tsno))
    return isnow, stc, snice, snliq, dzsnso


def snowh2o(p, dt, qsnfro, qsnsub, qrain, isnow, dzsnso, snowh, sneqv,
            snice, snliq, sh2o, sice, stc, dzsnso_soil1):
    """Snowpack liquid percolation (SNOWH2O, :6979-7126); positive
    thickness stack. Returns updated arrays + qsnbot, ponding1/2."""
    ponding1 = jnp.zeros_like(sneqv)
    ponding2 = jnp.zeros_like(sneqv)
    # no snowpack: frost/sublimation go to soil ice
    none_ = sneqv == 0.0
    sice = sice.at[0].set(jnp.where(
        none_, sice[0] + (qsnfro - qsnsub) * dt / (dzsnso_soil1 * 1000.0),
        sice[0]))
    fix = sice[0] < 0.0
    sh2o = sh2o.at[0].set(jnp.where(fix, sh2o[0] + sice[0], sh2o[0]))
    sice = sice.at[0].set(jnp.where(fix, 0.0, sice[0]))

    # bulk (layerless) snowpack
    bulk = (isnow == 0) & (sneqv > 0.0)
    temp = sneqv
    sneqv_n = sneqv - qsnsub * dt + qsnfro * dt
    propor = sneqv_n / jnp.maximum(temp, MPE)
    snowh_n = jnp.maximum(0.0, propor * snowh)
    snowh_n = jnp.minimum(jnp.maximum(snowh_n, sneqv_n / 500.0),
                          sneqv_n / 50.0)
    neg = sneqv_n < 0.0
    sice = sice.at[0].set(jnp.where(
        bulk & neg, sice[0] + sneqv_n / (dzsnso_soil1 * 1000.0), sice[0]))
    sneqv = jnp.where(bulk, jnp.maximum(sneqv_n, 0.0), sneqv)
    snowh = jnp.where(bulk, jnp.where(neg, 0.0, snowh_n), snowh)
    fix = sice[0] < 0.0
    sh2o = sh2o.at[0].set(jnp.where(fix, sh2o[0] + sice[0], sh2o[0]))
    sice = sice.at[0].set(jnp.where(fix, 0.0, sice[0]))

    tiny = (snowh <= 1e-8) | (sneqv <= 1e-6)
    snowh = jnp.where(tiny, 0.0, snowh)
    sneqv = jnp.where(tiny, 0.0, sneqv)

    # multilayer: sublimation from top layer, then a possible combine
    multi = isnow < 0
    mtop = isnow + NSNOW
    ice_t = _gather_m(snice, mtop)
    wgdif = ice_t - qsnsub * dt + qsnfro * dt
    snice = _scatter_m(snice, mtop, wgdif, multi)
    need_combine = multi & (wgdif < 1e-6)
    # the reference re-runs COMBINE for over-sublimated layers; calling it
    # unconditionally is equivalent (it no-ops when nothing qualifies)
    (isnow, sh2o, sice, stc, snice, snliq, dzsnso, snowh, sneqv,
     p1c, p2c) = combine_snow(p, isnow, sh2o, sice, stc, snice, snliq,
                              dzsnso, snowh, sneqv, dzsnso_soil1)
    ponding1 = ponding1 + p1c
    ponding2 = ponding2 + p2c
    multi = isnow < 0
    mtop = isnow + NSNOW
    liq_t = _gather_m(snliq, mtop)
    snliq = _scatter_m(snliq, mtop,
                       jnp.maximum(0.0, liq_t + qrain * dt), multi)

    # gravitational percolation, top-down
    smask = _snow_mask(isnow)[:NSNOW]
    dz_s = jnp.maximum(dzsnso[:NSNOW], MPE)
    vol_ice = jnp.minimum(1.0, snice / (dz_s * DENICE))
    epore = 1.0 - vol_ice
    qin = jnp.zeros_like(sneqv)
    qout = jnp.zeros_like(sneqv)
    max_liq_frac = 0.4
    for m in range(NSNOW):
        act = smask[m]
        liq_m = jnp.where(act, snliq[m] + qin, snliq[m])
        vol_liq = liq_m / (dz_s[m] * DENH2O)
        q = jnp.maximum(0.0, (vol_liq - p.ssi * epore[m]) * dzsnso[m])
        if m == NSNOW - 1:   # j == 0, bottom snow layer
            q = jnp.maximum((vol_liq - epore[m]) * dzsnso[m],
                            p.snow_ret_fac * dt * q)
        q = q * DENH2O
        liq_m = liq_m - jnp.where(act, q, 0.0)
        # cap liquid mass fraction at 0.4
        over = act & (liq_m / jnp.maximum(snice[m] + liq_m, MPE)
                      > max_liq_frac)
        cap = max_liq_frac / (1.0 - max_liq_frac) * snice[m]
        q = q + jnp.where(over, liq_m - cap, 0.0)
        liq_m = jnp.where(over, cap, liq_m)
        snliq = snliq.at[m].set(liq_m)
        qin = jnp.where(act, q, qin)
        qout = jnp.where(act, q, qout)
    dzsnso = dzsnso.at[:NSNOW].set(jnp.where(
        smask, jnp.maximum(dzsnso[:NSNOW],
                           snliq / DENH2O + snice / DENICE),
        dzsnso[:NSNOW]))
    qsnbot = qout / dt
    return (isnow, dzsnso, snowh, sneqv, snice, snliq, sh2o, sice, stc,
            qsnbot, ponding1, ponding2)


def snowwater(p, dt, zsoil, sfctmp, snowhin, qsnow, qsnfro, qsnsub,
              qrain, ficeold, imelt, isnow, snowh, sneqv, snice, snliq,
              sh2o, sice, stc, dzsnso):
    """Snow hydrology driver (SNOWWATER, :6300-6431). dzsnso arrives as
    the positive-thickness stack; returns it rebuilt along with zsnso."""
    dz3 = dzsnso[:NSNOW]
    isnow, snowh, sneqv, dz3, stc, snice, snliq = snowfall_acc(
        p, dt, qsnow, snowhin, sfctmp, isnow, snowh, sneqv, dz3, stc,
        snice, snliq)
    dz3 = compact_snow(p, dt, stc, snice, snliq, imelt, ficeold, isnow,
                       dz3)
    (isnow, sh2o, sice, stc, snice, snliq, dz3, snowh, sneqv, p1a,
     p2a) = combine_snow(p, isnow, sh2o, sice, stc, snice, snliq, dz3,
                         snowh, sneqv, dzsnso[NSNOW])
    isnow, stc, snice, snliq, dz3 = divide_snow(p, isnow, stc, snice,
                                                snliq, dz3)
    (isnow, dz3, snowh, sneqv, snice, snliq, sh2o, sice, stc, qsnbot,
     p1b, p2b) = snowh2o(p, dt, qsnfro, qsnsub, qrain, isnow, dz3,
                         snowh, sneqv, snice, snliq, sh2o, sice, stc,
                         dzsnso[NSNOW])
    ponding1 = p1a + p1b
    ponding2 = p2a + p2b

    # zero dead layers; glacier flow cap at 5000 mm (:6398-6405)
    smask = _snow_mask(isnow)[:NSNOW]
    snice = jnp.where(smask, snice, 0.0)
    snliq = jnp.where(smask, snliq, 0.0)
    stc = stc.at[:NSNOW].set(jnp.where(smask, stc[:NSNOW], 0.0))
    dz3 = jnp.where(smask, dz3, 0.0)
    snoflow = jnp.zeros_like(sneqv)
    over = sneqv > 5000.0
    m0 = NSNOW - 1
    bdsnow = snice[m0] / jnp.maximum(dz3[m0], MPE)
    flow = jnp.where(over, sneqv - 5000.0, 0.0)
    snice = snice.at[m0].set(jnp.where(over, snice[m0] - flow, snice[m0]))
    dz3 = dz3.at[m0].set(jnp.where(
        over, dz3[m0] - flow / jnp.maximum(bdsnow, MPE), dz3[m0]))
    snoflow = flow / dt
    multi = isnow < 0
    sneqv = jnp.where(multi,
                      jnp.sum(jnp.where(smask, snice + snliq, 0.0),
                              axis=0), sneqv)

    # rebuild zsnso/dzsnso (negative-downward bookkeeping, :6407-6429)
    dzsnso = dzsnso.at[:NSNOW].set(dz3)
    dz_soil = jnp.concatenate(
        [-zsoil[:1], -(zsoil[1:] - zsoil[:-1])])[:, None, None]
    dzsnso = dzsnso.at[NSNOW:].set(
        jnp.broadcast_to(dz_soil, dzsnso[NSNOW:].shape))
    act = _active(isnow)
    zsnso = jnp.cumsum(jnp.where(act, dzsnso, 0.0), axis=0)
    top_off = _gather_m(zsnso, isnow + NSNOW) - _gather_m(
        dzsnso, isnow + NSNOW)
    zsnso = -(zsnso - top_off[None])
    return (isnow, snowh, sneqv, snice, snliq, sh2o, sice, stc, zsnso,
            dzsnso, qsnbot, snoflow, ponding1, ponding2)


# ==========================================================================
# soil water (SOILWATER/SRT/SSTEP/WDFCND1, :7128-7894; OPT_RUN=1/OPT_INF=1)
# ==========================================================================

def wdfcnd1(p, smc, fcr):
    """Soil water diffusivity/conductivity, NY06-impedance (WDFCND1)."""
    factr = jnp.maximum(0.01, smc / p.smcmax[None])
    wdf = p.dwsat[None] * factr ** (p.bexp[None] + 2.0) * (1.0 - fcr)
    wcnd = p.dksat[None] * factr ** (2.0 * p.bexp[None] + 3.0) * (1.0 - fcr)
    return wdf, wcnd


def srt_sstep(p, dt, zsoil, dzsoil, pddum, etrani, qseva, sh2o, smc,
              zwt, fcr, smcwtd=None):
    """One Richards substep: SRT matrix + SSTEP tridiagonal update with
    saturation-excess push-up. Returns (sh2o, smc, wplus, wcnd)."""
    wdf, wcnd = wdfcnd1(p, smc, fcr)
    sice = jnp.maximum(smc - sh2o, 0.0)   # constant through the substep
    smx = smc
    zs = zsoil[:, None, None]
    zs_m1 = jnp.concatenate([jnp.zeros((1, 1, 1), zs.dtype), zs[:-1]],
                            axis=0)
    smx_p1 = jnp.concatenate([smx[1:], smx[-1:]], axis=0)
    denom = zs_m1 - zs                      # (z(k-1)-z(k)); row 1: -z(1)
    # per-row temp1: row 1: -z(2); rows k<NSOIL: z(k-1)-z(k+1);
    # bottom row: z(n-1)-z(n)
    temp1 = jnp.concatenate(
        [(-zs[1])[None]] + [(zs[k - 1] - zs[k + 1])[None]
                            for k in range(1, NSOIL - 1)]
        + [(zs[NSOIL - 2] - zs[NSOIL - 1])[None]], axis=0)
    ddz = 2.0 / temp1
    dsmdz = 2.0 * (smx - smx_p1) / temp1
    wdf_m1 = jnp.concatenate([wdf[:1], wdf[:-1]], axis=0)
    wcnd_m1 = jnp.concatenate([wcnd[:1], wcnd[:-1]], axis=0)
    dsmdz_m1 = jnp.concatenate([dsmdz[:1], dsmdz[:-1]], axis=0)
    ddz_m1 = jnp.concatenate([ddz[:1], ddz[:-1]], axis=0)

    wflux_top = (wdf[0] * dsmdz[0] + wcnd[0] - pddum + etrani[0] + qseva)
    wflux_mid = (wdf * dsmdz + wcnd - wdf_m1 * dsmdz_m1 - wcnd_m1
                 + etrani)
    qdrain = jnp.zeros_like(pddum)          # OPT_RUN = 1
    wflux_bot = (-(wdf_m1[-1] * dsmdz_m1[-1]) - wcnd_m1[-1]
                 + etrani[-1] + qdrain)
    wflux = wflux_mid.at[0].set(wflux_top).at[-1].set(wflux_bot)

    ai = -wdf_m1 * ddz_m1 / denom
    ai = ai.at[0].set(0.0)
    ci = -wdf * ddz / denom
    ci = ci.at[-1].set(0.0)
    bi_top = wdf[0] * ddz[0] / denom[0]
    bi = -(ai + ci)
    bi = bi.at[0].set(bi_top)
    ci = ci.at[0].set(-bi_top)
    rhstt = wflux / (-denom)

    a = ai * dt
    b = 1.0 + bi * dt
    c = ci * dt
    r = rhstt * dt
    active = jnp.ones(sh2o.shape, bool)
    is_top = jnp.zeros(sh2o.shape, bool).at[0].set(True)
    dsh = _thomas_stack(a, b, c, r, active)
    sh2o = sh2o + dsh

    # push saturation excess upward then downward (SSTEP :7760-7790)
    wplus = jnp.zeros_like(pddum)
    for k in range(NSOIL - 1, 0, -1):
        epore = jnp.maximum(1e-4, p.smcmax - sice[k])
        wp = jnp.maximum(sh2o[k] - epore, 0.0) * dzsoil[k]
        sh2o = sh2o.at[k].set(jnp.minimum(epore, sh2o[k]))
        sh2o = sh2o.at[k - 1].add(wp / dzsoil[k - 1])
    epore = jnp.maximum(1e-4, p.smcmax - sice[0])
    wplus = jnp.maximum(sh2o[0] - epore, 0.0) * dzsoil[0]
    sh2o = sh2o.at[0].set(jnp.minimum(epore, sh2o[0]))
    overflow = wplus > 0.0
    sh2o = sh2o.at[1].add(jnp.where(overflow, wplus / dzsoil[1], 0.0))
    for k in range(1, NSOIL - 1):
        epore = jnp.maximum(1e-4, p.smcmax - sice[k])
        wp = jnp.maximum(sh2o[k] - epore, 0.0) * dzsoil[k]
        sh2o = sh2o.at[k].set(jnp.minimum(epore, sh2o[k]))
        sh2o = sh2o.at[k + 1].add(wp / dzsoil[k + 1])
    epore = jnp.maximum(1e-4, p.smcmax - sice[-1])
    wp_last = jnp.maximum(sh2o[-1] - epore, 0.0) * dzsoil[-1]
    sh2o = sh2o.at[-1].set(jnp.minimum(epore, sh2o[-1]))
    wplus = wplus  # the reference's final WPLUS is the top-layer excess
    smc = sh2o + sice
    return sh2o, smc, wplus, wcnd


def soilwater(p, dt, zsoil, dzsoil, qinsur, qseva, etrani, sice, sh2o,
              smc, zwt):
    """Soil moisture driver (SOILWATER; OPT_RUN=1 SIMGM surface runoff +
    Richards substeps). Returns (sh2o, smc, runsrf, wcnd, fcrmax)."""
    # saturation excess clamp (:7205-7209)
    rsat = jnp.zeros_like(qinsur)
    epore = jnp.maximum(1e-4, p.smcmax[None] - sice)
    rsat = jnp.sum(jnp.maximum(0.0, sh2o - epore)
                   * dzsoil[:, None, None], axis=0)
    sh2o = jnp.minimum(epore, sh2o)

    a_ = 4.0
    fice = jnp.minimum(1.0, sice / p.smcmax[None])
    fcr = jnp.maximum(0.0, jnp.exp(-a_ * (1.0 - fice))
                      - jnp.exp(-a_)) / (1.0 - jnp.exp(-a_))
    fcrmax = jnp.max(fcr, axis=0)

    # SIMGM surface runoff (:7241-7248)
    fff = 6.0
    fsat = p.fsatmx * jnp.exp(-0.5 * fff * (zwt - 2.0))
    runsrf = jnp.where(qinsur > 0.0,
                       qinsur * ((1.0 - fcr[0]) * fsat + fcr[0]), 0.0)
    pddum = jnp.where(qinsur > 0.0, qinsur - runsrf, 0.0)

    niter = 3   # the reference doubles to 6 for heavy infiltration;
    # use the worst case uniformly (same scheme, finer substeps)
    dtfine = dt / niter
    wcnd = None
    for _ in range(niter):
        sh2o, smc, wplus, wcnd = srt_sstep(
            p, dtfine, zsoil, dzsoil, pddum, etrani, qseva, sh2o, smc,
            zwt, fcr)
        rsat = rsat + wplus
    runsrf = runsrf * 1000.0 + rsat * 1000.0 / dt
    return sh2o, smc, runsrf, wcnd, fcrmax


def groundwater(p, dt, sice, zsoil, dzsoil, stc, wcnd, fcrmax, sh2o,
                zwt, wa, wt):
    """SIMGM unconfined-aquifer groundwater (GROUNDWATER, :8243-8428)."""
    rous = 0.2
    cmic = 0.20
    dzmm = dzsoil[:, None, None] * 1e3
    zs = zsoil
    znode = jnp.concatenate(
        [(-zs[0] / 2.0)[None]]
        + [(-zs[iz - 1] + 0.5 * (zs[iz - 1] - zs[iz]))[None]
           for iz in range(1, NSOIL)])

    smc = sh2o + sice
    mliq = sh2o * dzmm
    epore = jnp.maximum(0.01, p.smcmax[None] - sice)
    hk = 1e3 * wcnd

    # layer index above the water table (1-based iwt in [1..NSOIL])
    iwt = jnp.full_like(zwt, NSOIL, jnp.int32)
    for iz in range(NSOIL, 1, -1):     # reverse so the FIRST match wins
        iwt = jnp.where(zwt <= -zs[iz - 1], iz - 1, iwt)
    i0 = iwt - 1   # 0-based

    fff, rsbmx = 6.0, 5.0
    qdis = (1.0 - fcrmax) * rsbmx * jnp.exp(-p.timean) \
        * jnp.exp(-fff * (zwt - 2.0))
    smc_i = _gather_m(smc, i0)
    hk_i = _gather_m(hk, i0)
    znode_i = znode[jnp.clip(i0, 0, NSOIL - 1)]
    s_node = jnp.clip(smc_i / p.smcmax, 0.01, 1.0)
    smpfz = -p.psisat * 1000.0 * s_node ** (-p.bexp)
    smpfz = jnp.maximum(-120000.0, cmic * smpfz)
    wh_zwt = -zwt * 1e3
    wh = smpfz - znode_i * 1e3
    qin = -hk_i * (wh_zwt - wh) / jnp.maximum((zwt - znode_i) * 1e3, MPE)
    qin = jnp.clip(qin, -10.0 / dt, 10.0 / dt)
    wt = wt + (qin - qdis) * dt

    deep = iwt == NSOIL
    wa_d = wa + (qin - qdis) * dt
    zwt_d = (-zs[-1] + 25.0) - wa_d / 1000.0 / rous
    mliq_last_d = mliq[-1] - qin * dt + jnp.maximum(0.0, wa_d - 5000.0)
    wa_new = jnp.where(deep, jnp.minimum(wa_d, 5000.0), wa)
    wt = jnp.where(deep, jnp.minimum(wa_d, 5000.0), wt)

    # shallow water table (:8382-8397)
    epore_sum = jnp.zeros_like(zwt)
    for iz in range(NSOIL):
        # sum epore over layers iwt+2..NSOIL (1-based) = 0-based > i0+1
        epore_sum = epore_sum + jnp.where(
            jnp.asarray(iz)[None, None] > i0 + 1,
            epore[iz] * dzmm[iz], 0.0)
    zwt_s1 = -zs[-1] - (wt - rous * 1000.0 * 25.0) / epore[-1] / 1000.0
    zwt_sn = (-jnp.take(jnp.concatenate([zs, zs[-1:]]),
                        jnp.clip(i0 + 1, 0, NSOIL - 1))
              - (wt - rous * 1000.0 * 25.0 - epore_sum)
              / _gather_m(epore, i0 + 1) / 1000.0)
    zwt = jnp.where(deep, zwt_d,
                    jnp.where(iwt == NSOIL - 1, zwt_s1, zwt_sn))
    wa = wa_new

    wtsub = jnp.sum(hk * dzmm, axis=0)
    mliq_shallow = mliq - qdis * dt * hk * dzmm / jnp.maximum(wtsub, MPE)
    mliq = jnp.where(deep[None], mliq.at[-1].set(mliq_last_d), mliq_shallow)

    zwt = jnp.maximum(1.5, zwt)

    # minimum-water redistribution (:8403-8420)
    watmin = 0.01
    for iz in range(NSOIL - 1):
        xs = jnp.where(mliq[iz] < 0.0, watmin - mliq[iz], 0.0)
        mliq = mliq.at[iz].add(xs)
        mliq = mliq.at[iz + 1].add(-xs)
    xs = jnp.where(mliq[-1] < watmin, watmin - mliq[-1], 0.0)
    mliq = mliq.at[-1].add(xs)
    wa = wa - xs
    wt = wt - xs
    sh2o = mliq / dzmm
    return sh2o, zwt, wa, wt, qin, qdis


# ==========================================================================
# water driver (WATER, :5902-6166)
# ==========================================================================

def water(p, dt, fcev, fctr, elai, esai, sfctmp, qvap, qdew, zsoil,
          dzsoil, btrani_frac, ficeold, ponding, tg, fveg, bdfall,
          qsnow, qrain, snowhin, frozen_canopy, frozen_ground, imelt,
          isnow, canliq, canice, tv, snowh, sneqv, snice, snliq, stc,
          zsnso, sh2o, smc, zwt, wa, wt, dzsnso):
    """Water budget: canopy -> snowpack -> soil -> groundwater."""
    (canliq, canice, tv, cmc, ecan, etran_rate, fwet) = canwater(
        p, dt, fcev, fctr, elai, esai, bdfall, frozen_canopy,
        canliq, canice, tv)
    # etran_rate is mm/s total transpiration (ETRAN in the reference)
    has_snow = sneqv > 0.0
    qsnsub = jnp.where(has_snow, jnp.minimum(qvap, sneqv / dt), 0.0)
    qseva = qvap - qsnsub
    qsnfro = jnp.where(has_snow, qdew, 0.0)
    qsdew = qdew - qsnfro

    sice = jnp.maximum(smc - sh2o, 0.0)
    (isnow, snowh, sneqv, snice, snliq, sh2o, sice, stc, zsnso, dzsnso,
     qsnbot, snoflow, ponding1, ponding2) = snowwater(
        p, dt, zsoil, sfctmp, snowhin, qsnow, qsnfro, qsnsub, qrain,
        ficeold, imelt, isnow, snowh, sneqv, snice, snliq, sh2o, sice,
        stc, dzsnso)

    # frozen ground: dew/evap exchange with soil ice (:5999-6007)
    fg = frozen_ground
    sice = sice.at[0].add(jnp.where(
        fg, (qsdew - qseva) * dt / (dzsoil[0] * 1000.0), 0.0))
    qsdew = jnp.where(fg, 0.0, qsdew)
    qseva = jnp.where(fg, 0.0, qseva)
    neg = sice[0] < 0.0
    sh2o = sh2o.at[0].set(jnp.where(neg, sh2o[0] + sice[0], sh2o[0]))
    sice = sice.at[0].set(jnp.where(neg, 0.0, sice[0]))

    qinsur = (ponding + ponding1 + ponding2) / dt * 0.001
    qinsur = qinsur + jnp.where(
        isnow == 0, (qsnbot + qsdew + qrain) * 0.001,
        (qsnbot + qsdew) * 0.001)
    qseva_m = qseva * 0.001
    etrani = etran_rate[None] * btrani_frac * 0.001   # (NSOIL, ny, nx) m/s

    smc = sh2o + sice
    sh2o, smc, runsrf, wcnd, fcrmax = soilwater(
        p, dt, zsoil, dzsoil, qinsur, qseva_m, etrani, sice, sh2o, smc,
        zwt)
    sh2o, zwt, wa, wt, qin, qdis = groundwater(
        p, dt, sice, zsoil, dzsoil, stc, wcnd, fcrmax, sh2o, zwt, wa, wt)
    runsub = qdis + snoflow
    smc = sh2o + sice
    return SimpleNamespace(
        isnow=isnow, canliq=canliq, canice=canice, tv=tv, snowh=snowh,
        sneqv=sneqv, snice=snice, snliq=snliq, stc=stc, zsnso=zsnso,
        sh2o=sh2o, smc=smc, sice=sice, zwt=zwt, wa=wa, wt=wt,
        dzsnso=dzsnso, cmc=cmc, ecan=ecan, etran=etran_rate, fwet=fwet,
        runsrf=runsrf, runsub=runsub, qin=qin, qdis=qdis,
        ponding1=ponding1, ponding2=ponding2, qsnbot=qsnbot)


# ==========================================================================
# top-level column driver (NOAHMP_SFLX, :417-605)
# ==========================================================================

def sflx(p, lat, yearlen, julian, cosz, dt, zsoil, dzsoil, shdfac,
         vegtype, sfctmp, sfcprs, psfc, uu, vv, q2, soldn, lwdn, prcp,
         tbot, foln, ficeold, zlvl, state):
    """One NoahMP step over the grid. ``state`` is a dict of prognostic
    fields (albold, sneqvo, stc, sh2o, smc, tah, eah, fwet, canliq,
    canice, tv, tg, qsfc, isnow, zsnso, snowh, sneqv, snice, snliq, zwt,
    wa, wt, lai, sai, cm, ch, tauss). Returns (outputs, new_state)."""
    s = dict(state)
    isnow = s["isnow"]
    dzsnso_all = jnp.zeros_like(s["zsnso"])
    # layer thickness from zsnso (:344-350)
    zs_m1 = jnp.concatenate([jnp.zeros_like(s["zsnso"][:1]),
                             s["zsnso"][:-1]], axis=0)
    is_top = _stack_j() == (isnow[None] + 1)
    dzsnso_all = jnp.where(is_top, -s["zsnso"], zs_m1 - s["zsnso"])
    act = _active(isnow)
    dzsnso_all = jnp.where(act, dzsnso_all, 0.0)
    dz_soil_static = jnp.concatenate(
        [-zsoil[:1], -(zsoil[1:] - zsoil[:-1])])[:, None, None]
    dzsnso_all = dzsnso_all.at[NSNOW:].set(
        jnp.broadcast_to(dz_soil_static, dzsnso_all[NSNOW:].shape))

    at = atm(p, sfcprs, sfctmp, q2, prcp, soldn, cosz)

    lai, sai, elai, esai, igs = phenology(
        p, vegtype, s["snowh"], s["tv"], lat, yearlen, julian)
    fveg = jnp.maximum(shdfac, 0.05)    # DVEG == 1
    fveg = jnp.where(p.urban_flag | (vegtype == p.isbarren), 0.0, fveg)
    fveg = jnp.where(elai + esai == 0.0, 0.0, fveg)

    ph = precip_heat(p, dt, uu, vv, elai, esai, fveg, at.bdfall, at.rain,
                     at.snow, at.fp, s["canliq"], s["canice"], s["tv"],
                     sfctmp, s["tg"])

    en = energy(
        p, vegtype, isnow, dt, at.rhoair, sfcprs, at.qair, sfctmp,
        at.thair, lwdn, uu, vv, zlvl, at.solad, at.solai, cosz, igs,
        at.eair, tbot, s["zsnso"], zsoil, elai, esai, ph.fwet, foln,
        fveg, ph.pahv, ph.pahg, ph.pahb, ph.qsnow, dzsnso_all, lat,
        ph.canliq, ph.canice, s["tv"], s["tg"], s["stc"], s["snowh"],
        s["eah"], s["tah"], s["sneqvo"], s["sneqv"], s["sh2o"], s["smc"],
        s["snice"], s["snliq"], s["albold"], s["cm"], s["ch"], q2,
        s["tauss"], psfc)

    sneqvo = en.sneqv
    qvap = jnp.maximum(en.fgev / en.latheag, 0.0)
    qdew = jnp.abs(jnp.minimum(en.fgev / en.latheag, 0.0))
    edir = qvap - qdew

    wt_ = water(
        p, dt, en.fcev, en.fctr, elai, esai, sfctmp, qvap, qdew, zsoil,
        dz_soil_static[:, 0, 0], en.btrani, ficeold, en.ponding, en.tg,
        fveg, at.bdfall, ph.qsnow, ph.qrain, ph.snowhin,
        en.frozen_canopy, en.frozen_ground, en.imelt, isnow, ph.canliq,
        ph.canice, en.tv, en.snowh, en.sneqv, en.snice, en.snliq,
        en.stc, s["zsnso"], en.sh2o, en.smc, s["zwt"], s["wa"], s["wt"],
        dzsnso_all)

    snowh = wt_.snowh
    sneqv = wt_.sneqv
    tiny = (snowh <= 1e-6) | (sneqv <= 1e-3)
    snowh = jnp.where(tiny, 0.0, snowh)
    sneqv = jnp.where(tiny, 0.0, sneqv)
    albedo = jnp.where(at.swdown > 0.0,
                       en.fsr / jnp.maximum(at.swdown, MPE), -999.9)
    qfx = wt_.etran + wt_.ecan + edir

    new_state = dict(
        albold=s["albold"], sneqvo=sneqvo, stc=wt_.stc, sh2o=wt_.sh2o,
        smc=wt_.smc, tah=en.tah, eah=en.eah, fwet=wt_.fwet,
        canliq=wt_.canliq, canice=wt_.canice, tv=wt_.tv, tg=en.tg,
        qsfc=en.qsfc, isnow=wt_.isnow, zsnso=wt_.zsnso, snowh=snowh,
        sneqv=sneqv, snice=wt_.snice, snliq=wt_.snliq, zwt=wt_.zwt,
        wa=wt_.wa, wt=wt_.wt, lai=lai, sai=sai, cm=en.cm, ch=en.ch,
        tauss=en.tauss)
    outputs = dict(
        fsa=en.fsa, fsr=en.fsr, fira=en.fira, fsh=en.fsh, fcev=en.fcev,
        fgev=en.fgev, fctr=en.fctr, ssoil=en.ssoil, trad=en.trad,
        ecan=wt_.ecan, etran=wt_.etran, edir=edir, runsrf=wt_.runsrf,
        runsub=wt_.runsub, apar=en.apar, psn=en.psn, sav=en.sav,
        sag=en.sag, fsno=en.fsno, fveg=fveg, albedo=albedo,
        qsnbot=wt_.qsnbot, ponding=en.ponding, t2m=en.t2m, q2e=en.q2e,
        q1=en.q1, emissi=en.emissi, z0wrf=en.z0wrf, qfx=qfx, qmelt=en.qmelt,
        t2mv=en.t2mv, t2mb=en.t2mb, q2v=en.q2v, q2b=en.q2b,
        chv=en.chv, chb=en.chb, tgv=en.tgv, tgb=en.tgb,
        rssun=en.rssun, rssha=en.rssha, lai=lai, sai=sai,
        elai=elai, esai=esai, fpice=at.fpice, laisun=en.laisun,
        laisha=en.laisha)
    return outputs, new_state


# ==========================================================================
# host-side state initialization (NOAHMP_INIT + SNOW_INIT,
# lsm_noahmpdrv.f90:1443-2149)
# ==========================================================================

ZSOIL = -np.cumsum(np.array([0.1, 0.3, 0.6, 1.0], np.float32))
DZSOIL = np.array([0.1, 0.3, 0.6, 1.0], np.float32)


def noahmp_init_state(tsk, swe, snow_height, soil_t, soil_m, soiltype,
                      vegtype, mp_tables, noah_tables) -> Dict[str, np.ndarray]:
    """Initial NoahMP prognostic state from ICAR's surface fields.
    All inputs numpy (ny, nx) except soil_t/soil_m (NSOIL, ny, nx)."""
    ny, nx = tsk.shape
    snow = np.asarray(swe, np.float64).copy()
    snowh = np.asarray(snow_height, np.float64).copy()
    nosnowh = (snowh == 0.0) & (snow > 0.0)
    snowh = np.where(nosnowh, snow * 0.005, snowh)
    over = snow > 5000.0
    snowh = np.where(over, snowh * 5000.0 / np.maximum(snow, 1.0), snowh)
    snow = np.minimum(snow, 5000.0)

    si = np.clip(soiltype.astype(np.int32), 1, 19)
    from .noah_params import load_tables
    nt = noah_tables
    bexp = np.asarray(nt.bb)[si]
    smcmax = np.asarray(nt.maxsmc)[si]
    psisat = np.asarray(nt.satpsi)[si]
    smois = np.minimum(np.asarray(soil_m, np.float32), smcmax[None])
    tslb = np.asarray(soil_t, np.float32)
    hlice, grav_, t0 = 3.335e5, 9.81, 273.15
    with np.errstate(invalid="ignore", divide="ignore"):
        fk = ((hlice / (grav_ * (-psisat[None])))
              * ((tslb - t0) / tslb)) ** (-1.0 / bexp[None]) * smcmax[None]
    fk = np.maximum(np.where(np.isfinite(fk), fk, 0.02), 0.02)
    sh2o = np.where(tslb < 273.149, np.minimum(fk, smois), smois)

    # glacier cells start fully frozen (noahmp_init, :1792-1800)
    isice = np.asarray(vegtype) == mp_tables.isice
    smois = np.where(isice[None], 1.0, smois)
    sh2o = np.where(isice[None], 0.0, sh2o)
    tslb = np.where(isice[None], np.minimum(tslb, 263.15), tslb)
    snow = np.where(isice, np.maximum(snow, 10.0), snow)
    snowh = np.where(isice, snow * 0.01, snowh)

    cold = (snow > 0.0) & (tsk > 273.15)
    t_init = np.where(cold, 273.15, tsk).astype(np.float32)

    s = {}
    s["tv"] = t_init.copy()
    s["tg"] = t_init.copy()
    s["canliq"] = np.zeros((ny, nx), np.float32)
    s["canice"] = np.zeros((ny, nx), np.float32)
    s["eah"] = np.full((ny, nx), 2000.0, np.float32)
    s["tah"] = t_init.copy()
    s["cm"] = np.zeros((ny, nx), np.float32)
    s["ch"] = np.zeros((ny, nx), np.float32)
    s["fwet"] = np.zeros((ny, nx), np.float32)
    s["sneqvo"] = np.zeros((ny, nx), np.float32)
    s["albold"] = np.full((ny, nx), 0.65, np.float32)
    s["qsfc"] = np.zeros((ny, nx), np.float32)
    s["tauss"] = np.zeros((ny, nx), np.float32)
    # SIMGM aquifer start (:1824-1828)
    s["wa"] = np.full((ny, nx), 4900.0, np.float32)
    s["wt"] = s["wa"].copy()
    s["zwt"] = np.full((ny, nx), (25.0 + 2.0) - 4900.0 / 1000.0 / 0.2,
                       np.float32)
    t = mp_tables
    noveg = ((vegtype == t.isbarren) | (vegtype == t.isice)
             | (vegtype == t.isurban) | (vegtype == t.iswater))
    lai0 = np.where(noveg, 0.0, 0.5)
    s["lai"] = lai0.astype(np.float32)
    s["sai"] = np.where(noveg, 0.0,
                        np.maximum(0.1 * lai0, 0.05)).astype(np.float32)
    s["smc"] = smois.astype(np.float32)
    s["sh2o"] = sh2o.astype(np.float32)

    # snow layer structure (SNOW_INIT, :2047-2149)
    sd = snowh
    isnow = np.zeros((ny, nx), np.int32)
    dzsno = np.zeros((NSNOW, ny, nx), np.float64)   # m index: j + 2
    m0, m1, m2 = NSNOW - 1, NSNOW - 2, NSNOW - 3

    b1 = (sd >= 0.025) & (sd <= 0.05)
    isnow = np.where(b1, -1, isnow)
    dzsno[m0] = np.where(b1, sd, dzsno[m0])
    b2 = (sd > 0.05) & (sd <= 0.10)
    isnow = np.where(b2, -2, isnow)
    dzsno[m1] = np.where(b2, sd / 2.0, dzsno[m1])
    dzsno[m0] = np.where(b2, sd / 2.0, dzsno[m0])
    b3 = (sd > 0.10) & (sd <= 0.25)
    isnow = np.where(b3, -2, isnow)
    dzsno[m1] = np.where(b3, 0.05, dzsno[m1])
    dzsno[m0] = np.where(b3, sd - 0.05, dzsno[m0])
    b4 = (sd > 0.25) & (sd <= 0.45)
    isnow = np.where(b4, -3, isnow)
    dzsno[m2] = np.where(b4, 0.05, dzsno[m2])
    dzsno[m1] = np.where(b4, 0.5 * (sd - 0.05), dzsno[m1])
    dzsno[m0] = np.where(b4, 0.5 * (sd - 0.05), dzsno[m0])
    b5 = sd > 0.45
    isnow = np.where(b5, -3, isnow)
    dzsno[m2] = np.where(b5, 0.05, dzsno[m2])
    dzsno[m1] = np.where(b5, 0.20, dzsno[m1])
    dzsno[m0] = np.where(b5, sd - 0.25, dzsno[m0])

    tsno = np.zeros((NSNOW, ny, nx), np.float32)
    snice = np.zeros((NSNOW, ny, nx), np.float32)
    snliq = np.zeros((NSNOW, ny, nx), np.float32)
    for m in range(NSNOW):
        j = m - (NSNOW - 1)
        active = j >= isnow + 1
        tsno[m] = np.where(active, s["tg"], 0.0)
        snice[m] = np.where(
            active, dzsno[m] * (snow / np.maximum(sd, 1e-12)), 0.0)

    # zsnso: cumulative layer-bottom depths (negative down)
    dzsnso = np.zeros((NSS, ny, nx), np.float64)
    dzsnso[:NSNOW] = dzsno
    dzsnso[NSNOW:] = DZSOIL[:, None, None]
    zsnso = np.zeros((NSS, ny, nx), np.float32)
    run = np.zeros((ny, nx), np.float64)
    for m in range(NSS):
        j = m - (NSNOW - 1)
        active = j >= isnow + 1
        run = np.where(active, run + dzsnso[m], run)
        zsnso[m] = np.where(active, -run, 0.0)

    s["isnow"] = isnow
    s["snowh"] = snowh.astype(np.float32)
    s["sneqv"] = snow.astype(np.float32)
    s["snice"] = snice
    s["snliq"] = snliq
    s["zsnso"] = zsnso
    # snow temperatures occupy the snow part of stc
    s["stc"] = np.concatenate([tsno, tslb], axis=0).astype(np.float32)
    return s


def noahmp_driver(p, lat, yearlen, julian, cosz, dt, shdfac, vegtype,
                  sfctmp, sfcprs, psfc, uu, vv, q2, soldn, lwdn,
                  prcp_mm, tbot, zlvl, state):
    """Grid-level NoahMP step (noahmplsm, lsm_noahmpdrv.f90:520-1160):
    unit conversions + sflx + output packaging. ``prcp_mm`` is the precip
    accumulated since the last call (mm); q2 is mixing ratio (converted
    to specific humidity as in the WRF driver)."""
    qair = q2 / (1.0 + q2)
    prcp = prcp_mm / dt
    ficeold = jnp.where(
        state["snice"] + state["snliq"] > 0.0,
        state["snice"] / jnp.maximum(state["snice"] + state["snliq"],
                                     MPE), 0.0)
    foln = jnp.ones_like(sfctmp)
    out, new = sflx(p, lat, yearlen, julian, cosz, dt,
                    jnp.asarray(ZSOIL), jnp.asarray(DZSOIL), shdfac,
                    vegtype, sfctmp, sfcprs, psfc, uu, vv, qair, soldn,
                    lwdn, prcp, tbot, foln, ficeold, zlvl, state)
    # fluxes back to ICAR conventions (lsm_driver takes W/m2 up)
    out["hfx"] = out["fsh"]
    out["lh"] = out["fcev"] + out["fgev"] + out["fctr"]
    out["grdflx"] = out["ssoil"]
    out["tsk"] = out["trad"]
    return out, new
