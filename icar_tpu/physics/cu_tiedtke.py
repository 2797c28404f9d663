"""Tiedtke mass-flux cumulus convection (Tiedtke 1989, ECMWF).

JAX re-implementation of /root/reference/src/physics/cu_tiedtke.f90
(CU_TIEDTKE -> TIECNV -> CUMASTR_NEW and its subtree), vectorized over
(ny, nx) columns. The scheme runs in the reference's vertical
convention — index 0 = model top, KLEV-1 = lowest layer — so every
k+1/k-1 of the Fortran maps verbatim; the public driver flips the
model's bottom-up arrays at entry and exit.

Components: half-level environment (CUINI), non-entraining sub-cloud
ascent to the lifting condensation level (CUBASE), moisture-convergence
trigger, entraining/detraining updraft with organized entrainment and
the Nordeng CAPE closure (CUASC/CUENTR, orgen=1/nturben=1/cutrigger=1
compile-time defaults), mid-level onset (CUBASMC), downdrafts
(CUDLFS/CUDDRAF), flux finalization with snow melt and sub-cloud rain
evaporation (CUFLX), and T/q tendency assembly (CUDTDQ).

Deliberate parity notes:
- Momentum tendencies (CUDUDV/LMFDUDV tracking) are omitted: ICAR
  computes them but the application is commented out
  (cu_driver.f90:502-508), so they never reach the model state.
- The reference derives `leveltop` for mid-level convection from
  column i=1 of each j-row; here it is per-column.
- Per-column `sig1` (half-level sigma) replaces the single shared
  column ICAR passes.

All specific humidities internally (TIECNV converts mixing ratios).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.indexing import take_level

# constants (cu_tiedtke.f90:38-148)
G = 9.806
ZRG = 1.0 / G
CPD = 1005.46
RCPD = 1.0 / CPD
RD = 287.05
RV = 461.51
ALV = 2.5008e6
ALS = 2.8345e6
ALF = ALS - ALV
TMELT = 273.16
C1ES = 610.78
C2ES = C1ES * RD / RV
C3LES, C4LES = 17.269, 35.86
C3IES, C4IES = 21.875, 7.66
C5LES = C3LES * (TMELT - C4LES)
C5IES = C3IES * (TMELT - C4IES)
VTMPC1 = RV / RD - 1.0
T000 = 273.15
HGFR = 233.15

ENTRPEN = 1.0e-4
ENTRSCV = 1.2e-3
ENTRMID = 1.0e-4
ENTRDD = 2.0e-4
CMFCTOP = 0.30
CMFCMAX = 1.0
CMFCMIN = 1e-10
CMFDEPS = 0.30
CPRCON = 1.1e-3 / G
ZDNOPRC = 1.5e4
RHC, RHM = 0.80, 1.0
ZBUO0 = 0.50
CRIRH = 0.70
FDBK = 1.0
ZTAU = 1800.0
CEVAPCU1 = 1.93e-6 * 261.0 * 0.5 / G
CEVAPCU2 = 1e3 / (38.3 * 0.293)


def tlucua(tt):
    warm = (tt - TMELT) > 0.0
    zcvm3 = jnp.where(warm, C3LES, C3IES)
    zcvm4 = jnp.where(warm, C4LES, C4IES)
    return C2ES * jnp.exp(zcvm3 * (tt - TMELT) / (tt - zcvm4))


def tlucub(tt):
    warm = (tt - TMELT) > 0.0
    zcvm4 = jnp.where(warm, C4LES, C4IES)
    zcvm5 = jnp.where(warm, C5LES * ALV / CPD, C5IES * ALS / CPD)
    return zcvm5 * (1.0 / (tt - zcvm4)) ** 2


def tlucuc(tt):
    return jnp.where((tt - TMELT) > 0.0, ALV / CPD, ALS / CPD)


def _qsat(tt, p):
    qs = jnp.minimum(0.5, tlucua(tt) / p)
    return qs / (1.0 - VTMPC1 * qs)


def cuadjtq(t, q, p, mask, kcall):
    """Two-iteration saturation adjustment at one level
    (CUADJTQ, cu_tiedtke.f90:3170-3325). kcall: 1 = condensation only
    (>=0), 2 = evaporation only (<=0), 0/4 = both signs. The second
    iteration only touches cells the first one changed (kcall 1/2)."""
    def one_pass(t, q, m):
        zqsat = jnp.minimum(0.5, tlucua(t) / p)
        zcor = 1.0 / (1.0 - VTMPC1 * zqsat)
        zqsat = zqsat * zcor
        cond = (q - zqsat) / (1.0 + zqsat * zcor * tlucub(t))
        return jnp.where(m, cond, 0.0)

    cond1 = one_pass(t, q, mask)
    if kcall == 1:
        cond1 = jnp.maximum(cond1, 0.0)
    elif kcall == 2:
        cond1 = jnp.minimum(cond1, 0.0)
    t = t + tlucuc(t) * cond1
    q = q - cond1
    mask2 = mask if kcall in (0, 4) else (mask & (cond1 != 0.0))
    cond2 = one_pass(t, q, mask2)
    t = t + tlucuc(t) * cond2
    q = q - cond2
    return t, q


def _lev(arr, kidx):
    """arr[(k), ny, nx] selected at per-column level kidx (ny, nx)."""
    return take_level(arr, kidx)


def cumastr(ten, qen, uen, ven, verv, qsen, qhfl, dt, pap, paph, geo,
            qte_in, lndj, sig1):
    """CUMASTR_NEW (cu_tiedtke.f90:721-1244). All arrays top-down.

    Returns (tte, qte_add, cte, rsfc, ssfc, ldcum)."""
    KLEV = ten.shape[0]
    shape2 = ten.shape[1:]
    zcons2 = 1.0 / (G * dt)
    f2 = lambda v: jnp.full(shape2, v, ten.dtype)
    zero2 = jnp.zeros(shape2, ten.dtype)
    zero3 = jnp.zeros_like(ten)
    karr = jnp.arange(KLEV)[:, None, None]

    # ---- CUINI (cu_tiedtke.f90:1256-1388) ------------------------------
    geoh = jnp.concatenate([geo[:1],
                            geo[1:] + (geo[:-1] - geo[1:]) * 0.5], 0)
    tenh_mid = (jnp.maximum(CPD * ten[:-1] + geo[:-1],
                            CPD * ten[1:] + geo[1:]) - geoh[1:]) * RCPD
    tenh = jnp.concatenate([ten[:1], tenh_mid], 0)
    qsenh = jnp.concatenate([qsen[:1], qsen[:-1]], 0)
    # saturation at half levels via CUADJTQ(kcall=0)
    th_list = [tenh[0]]
    qsh_list = [qsenh[0]]
    for k in range(1, KLEV):
        tk, qk = cuadjtq(tenh[k], qsenh[k], paph[k],
                         jnp.ones(shape2, bool), 0)
        th_list.append(tk)
        qsh_list.append(qk)
    tenh = jnp.stack(th_list)
    qsenh = jnp.stack(qsh_list)
    qenh_mid = jnp.maximum(jnp.minimum(qen[:-1], qsen[:-1])
                           + (qsenh[1:] - qsen[:-1]), 0.0)
    qenh = jnp.concatenate([qen[:1], qenh_mid], 0)
    qenh = qenh.at[KLEV - 1].set(qen[KLEV - 1])
    tenh = tenh.at[KLEV - 1].set((CPD * ten[KLEV - 1] + geo[KLEV - 1]
                                  - geoh[KLEV - 1]) * RCPD)
    # static-stability adjustment sweep (bottom-up)
    th_rows = [tenh[k] for k in range(KLEV)]
    for k in range(KLEV - 2, 0, -1):
        zzs = jnp.maximum(CPD * th_rows[k] + geoh[k],
                          CPD * th_rows[k + 1] + geoh[k + 1])
        th_rows[k] = (zzs - geoh[k]) * RCPD
    tenh = jnp.stack(th_rows)
    # level of minimum omega
    wmasked = jnp.where(karr >= 2, verv, jnp.inf)
    klwmin = jnp.argmin(wmasked, axis=0).astype(jnp.int32)

    ptu = tenh
    pqu = qenh
    ztd = tenh
    zqd = qenh
    plu = zero3

    # ---- CUBASE (cu_tiedtke.f90:1393-1537) -----------------------------
    klab = jnp.broadcast_to(jnp.where(karr == KLEV - 1, 1, 0),
                            ten.shape).astype(jnp.int32)
    kcbot = jnp.full(shape2, KLEV - 2, jnp.int32)
    ldcum = jnp.zeros(shape2, bool)
    ptu_rows = [ptu[k] for k in range(KLEV)]
    pqu_rows = [pqu[k] for k in range(KLEV)]
    plu_rows = [plu[k] for k in range(KLEV)]
    klab_rows = [klab[k] for k in range(KLEV)]
    for k in range(KLEV - 2, 0, -1):
        lo = klab_rows[k + 1] == 1
        pqu_k = jnp.where(lo, pqu_rows[k + 1], pqu_rows[k])
        ptu_k = jnp.where(lo, (CPD * ptu_rows[k + 1] + geoh[k + 1]
                               - geoh[k]) * RCPD, ptu_rows[k])
        zbuo = ptu_k * (1. + VTMPC1 * pqu_k) \
            - tenh[k] * (1. + VTMPC1 * qenh[k]) + ZBUO0
        klab_rows[k] = jnp.where(lo & (zbuo > 0.), 1, klab_rows[k])
        zqold = pqu_k
        ptu_k, pqu_k = cuadjtq(ptu_k, pqu_k, paph[k], lo, 1)
        condensed = lo & (pqu_k != zqold)
        klab_rows[k] = jnp.where(condensed, 2, klab_rows[k])
        plu_rows[k] = jnp.where(condensed,
                                plu_rows[k] + zqold - pqu_k, plu_rows[k])
        zbuo = ptu_k * (1. + VTMPC1 * pqu_k) \
            - tenh[k] * (1. + VTMPC1 * qenh[k]) + ZBUO0
        newbase = condensed & (zbuo > 0.)
        kcbot = jnp.where(newbase, k, kcbot)
        ldcum = ldcum | newbase
        ptu_rows[k] = ptu_k
        pqu_rows[k] = pqu_k
    ptu = jnp.stack(ptu_rows)
    pqu = jnp.stack(pqu_rows)
    plu = jnp.stack(plu_rows)
    klab = jnp.stack(klab_rows)

    # ---- trigger: moisture convergence (cutrigger=1; :885-905) ---------
    dpaph = paph[1:] - paph[:-1]                   # (KLEV, ...)
    zdqcv = jnp.sum(qte_in * dpaph, axis=0)
    zdqpbl = jnp.sum(jnp.where(karr >= kcbot[None], qte_in * dpaph, 0.0),
                     axis=0)
    ktype = jnp.where(zdqcv > jnp.maximum(0.0, 1.1 * qhfl * G), 1, 2)

    # ---- cloud-base mass flux (:920-935) -------------------------------
    qu_b = _lev(pqu, kcbot)
    lu_b = _lev(plu, kcbot)
    qenh_b = _lev(qenh, kcbot)
    zqumqe = qu_b + lu_b - qenh_b
    zdqmin = jnp.maximum(0.01 * qenh_b, 1e-10)
    ok = (zdqpbl > 0.) & (zqumqe > zdqmin) & ldcum
    zmfub = jnp.where(ok, zdqpbl / (G * jnp.maximum(zqumqe, zdqmin)),
                      0.01)
    ldcum = ldcum & ok
    zmfmax = (_lev(paph, kcbot) - _lev(paph, kcbot - 1)) * zcons2
    zmfub = jnp.minimum(zmfub, zmfmax)

    # ---- cloud height estimate + hhat (:940-975) -----------------------
    tu_b = _lev(ptu, kcbot)
    geoh_b = _lev(geoh, kcbot)
    zhcbase = CPD * tu_b + geoh_b + ALV * qu_b
    zalvdcp = ALV / CPD
    zqalv = 1.0 / ALV
    zhsat = CPD * tenh + geoh + ALV * qsenh
    zgam = C5LES * zalvdcp * qsenh / ((1. - VTMPC1 * qsenh)
                                      * (tenh - C4LES) ** 2)
    zzz = CPD * tenh * 0.608
    zhhat = zhsat - (zzz + zgam * zzz) / (1. + zgam * zzz * zqalv) \
        * jnp.maximum(qsenh - qenh, 0.0)
    zhhatt = zhhat
    # ictop0: lowest k (scanning up from base) where zhcbase > zhhat
    ictop0 = kcbot - 1
    for k in range(KLEV - 2, 1, -1):
        hit = (k < ictop0) & (zhcbase > zhhat[k])
        ictop0 = jnp.where(hit, k, ictop0)

    # ---- lowest organized detrainment level (:976-1010) ----------------
    deep = ldcum & (ktype == 1)
    ihmin = jnp.where(deep, kcbot, -1)
    zhmin = zero2
    zbi = 1.0 / (25.0 * G)
    ihmin_out = ihmin
    found = ~deep
    geoh_base = _lev(geoh, kcbot)      # hoisted: loop-invariant gather
    for k in range(KLEV - 1, -1, -1):
        act = deep & (k < kcbot) & (k >= ictop0) & ~found
        if k >= 1:
            zro = RD * tenh[k] / (G * paph[k])
            zdz = (paph[k] - paph[k - 1]) * zro
            dgeo = geo[k - 1] - geo[k]
            zdhdz = (CPD * (ten[k - 1] - ten[k])
                     + ALV * (qen[k - 1] - qen[k]) + dgeo) * G \
                / jnp.where(dgeo == 0, 1.0, dgeo)
            zdepth = geoh[k] - geoh_base
            zfac = jnp.sqrt(1. + zdepth * zbi)
            zhmin = jnp.where(act, zhmin + zdhdz * zfac * zdz, zhmin)
            zrh = -ALV * (qsenh[k] - qenh[k]) * zfac
            hit = act & (zhmin > zrh)
            ihmin_out = jnp.where(hit & ~found, k, ihmin_out)
            found = found | hit
    ihmin = jnp.where(deep, jnp.maximum(ihmin_out, ictop0), ihmin)
    zentr = jnp.where(ktype == 1, ENTRPEN, ENTRSCV)
    zentr = jnp.where(lndj == 1, zentr * 1.05, zentr)

    def ascent(zmfub, zentr, ktype, klab_in, ldcum_in, kcbot, ictop0,
               ptu_in, pqu_in, plu_in):
        return cuasc(tenh, qenh, ten, qen, qsen, geo, geoh, pap, paph,
                     qte_in, verv, klwmin, ldcum_in, zhcbase, ktype,
                     klab_in, ptu_in, pqu_in, plu_in, zmfub, zentr,
                     kcbot, ictop0, dt, ihmin, zhhatt, qsenh)

    # ---- first ascent (:1012-1031) -------------------------------------
    (ldcum1, ktype1, kcbot1, kctop, ptu1, pqu1, plu1, pmfu, zmfus,
     zmfuq, zmful, plude, zdmfup, klab1) = ascent(
        zmfub, zentr, ktype, klab, ldcum, kcbot, ictop0, ptu, pqu, plu)

    # check cloud depth; shallow -> re-classify (:1032-1045)
    zpbmpt = _lev(paph, kcbot1) - _lev(paph, kctop)
    ictop0 = jnp.where(ldcum1, kctop, ictop0)
    ktype1 = jnp.where(ldcum1 & (ktype1 == 1) & (zpbmpt < ZDNOPRC), 2,
                       ktype1)
    zentr = jnp.where(ktype1 == 2,
                      jnp.where(lndj == 1, ENTRSCV * 1.05, ENTRSCV),
                      zentr)
    zrfl = jnp.sum(zdmfup, axis=0)

    # ---- downdrafts (:1050-1065) ---------------------------------------
    (ztd, zqd, pmfd, zmfds, zmfdq, zdmfdp, idtop,
     loddraf) = cudlfs_cuddraf(tenh, qenh, geoh, paph, ptu1, pqu1,
                               ldcum1, kcbot1, kctop, zmfub, zrfl)

    # ---- CAPE closure for deep convection (:1070-1135) -----------------
    zheat = zero2
    zcape = zero2
    zrelh = zero2
    # ktop0: lowest level with p within 50 hPa of 300 hPa
    p_hpa = paph * 0.01
    near300 = jnp.abs(p_hpa[1:KLEV] - 300.0) < 50.0
    kk300 = jnp.where(jnp.any(near300, axis=0),
                      (KLEV - 1) - jnp.argmax(near300[::-1], axis=0),
                      KLEV - 1).astype(jnp.int32)
    ktop0 = jnp.maximum(kk300, kctop)
    paph_cb1 = _lev(paph, kcbot1)      # hoisted: loop-invariant gathers
    paph_kt0 = _lev(paph, ktop0)
    for k in range(1, KLEV):
        inside = (k <= kcbot1) & (k > kctop)
        zro = paph[k] / (RD * tenh[k])
        zdz = (paph[k] - paph[k - 1]) / (G * zro)
        zheat = zheat + jnp.where(
            inside & ldcum1,
            ((ten[k - 1] - ten[k] + G * zdz / CPD) / tenh[k]
             + 0.608 * (qen[k - 1] - qen[k]))
            * (pmfu[k] + pmfd[k]) * G / zro, 0.0)
        zcape = zcape + jnp.where(
            inside & ldcum1,
            G * ((ptu1[k] * (1. + .608 * pqu1[k] - plu1[k]))
                 / (tenh[k] * (1. + .608 * qenh[k])) - 1.0) * zdz, 0.0)
        in_rh = (k <= kcbot1) & (k > ktop0)
        dept = (paph[k] - paph[k - 1]) \
            / jnp.maximum(paph_cb1 - paph_kt0, 1e-10)
        zrelh = zrelh + jnp.where(in_rh & ldcum1,
                                  dept * qen[k] / qsen[k], 0.0)
    crirh1 = jnp.where(lndj == 1, CRIRH * 0.8, CRIRH)
    deep1 = ldcum1 & (ktype1 == 1)
    cape_ok = (zrelh >= crirh1) & (zcape > 100.0)
    zht = zcape / (ZTAU * jnp.where(zheat == 0, 1.0, zheat))
    zmfub1_deep = jnp.maximum(zmfub * zht, 0.01)
    zmfmax = (_lev(paph, kcbot1) - _lev(paph, kcbot1 - 1)) * zcons2
    zmfub1_deep = jnp.minimum(zmfub1_deep, zmfmax)
    zmfub1 = jnp.where(deep1, jnp.where(cape_ok, zmfub1_deep, 0.01),
                       zmfub)
    zmfub = jnp.where(deep1 & ~cape_ok, 0.01, zmfub)
    ldcum1 = ldcum1 & ~(deep1 & ~cape_ok)

    # shallow/mid: PBL equilibrium incl. downdraft moistening (:1137-1165)
    notdeep = ktype1 != 1
    zeps = jnp.where((_lev(pmfd, kcbot1) < 0.0) & loddraf, CMFDEPS, 0.0)
    qd_b = _lev(zqd, kcbot1)
    zqumqe2 = _lev(pqu1, kcbot1) + _lev(plu1, kcbot1) \
        - zeps * qd_b - (1. - zeps) * _lev(qenh, kcbot1)
    zdqmin2 = jnp.maximum(0.01 * _lev(qenh, kcbot1), 1e-10)
    cond_s = (zdqpbl > 0.) & (zqumqe2 > zdqmin2) & ldcum1 \
        & (zmfub < zmfmax)
    zmfub1_sh = jnp.where(cond_s,
                          zdqpbl / (G * jnp.maximum(zqumqe2, zdqmin2)),
                          zmfub)
    keep = (ktype1 == 2) & (jnp.abs(zmfub1_sh - zmfub) < 0.2 * zmfub)
    zmfub1_sh = jnp.where(keep, zmfub1_sh, zmfub)
    zmfub1_sh = jnp.minimum(zmfub1_sh, zmfmax)
    zmfub1 = jnp.where(notdeep, zmfub1_sh, zmfub1)

    zfac = zmfub1 / jnp.maximum(zmfub, 1e-10)
    pmfd = jnp.where(ldcum1[None], pmfd * zfac[None], 0.0)
    zmfds = jnp.where(ldcum1[None], zmfds * zfac[None], 0.0)
    zmfdq = jnp.where(ldcum1[None], zmfdq * zfac[None], 0.0)
    zdmfdp = jnp.where(ldcum1[None], zdmfdp * zfac[None], 0.0)
    zmfub = jnp.where(ldcum1, zmfub1, 0.0)

    # ---- final ascent (:1170-1185) -------------------------------------
    (ldcum2, ktype2, kcbot2, kctop, ptu2, pqu2, plu2, pmfu, zmfus,
     zmfuq, zmful, plude, zdmfup, _) = ascent(
        zmfub, zentr, ktype1, klab1, ldcum1, kcbot1, ictop0, ptu1, pqu1,
        plu1)

    # ---- CUFLX (:2670-2860) --------------------------------------------
    (pmfu, pmfd, zmfus, zmfds, zmfuq, zmfdq, zmful, plude, zdmfup,
     zdmfdp, zrfl2, zsfl, zdpmel, prain, ldcum3,
     ktype3) = cuflx(qen, qsen, tenh, qenh, paph, geoh, kcbot2, kctop,
                     idtop, ktype2, loddraf, ldcum2, pmfu, pmfd, zmfus,
                     zmfds, zmfuq, zmfdq, zmful, plude, zdmfup, zdmfdp,
                     ten, dt, sig1)

    # ---- CUDTDQ (:2862-2975) -------------------------------------------
    tte, qte_add, cte = cudtdq(paph, ldcum3, ten, zmfus, zmfds, zmfuq,
                               zmfdq, zmful, zdmfup, zdmfdp, zdpmel,
                               qen, qsen, plude)
    return tte, qte_add, cte, zrfl2, zsfl, ldcum3


def cuasc(tenh, qenh, ten, qen, qsen, geo, geoh, pap, paph, qte, verv,
          klwmin, ldcum, zhcbase, ktype, klab, ptu, pqu, plu, zmfub,
          zentr, kcbot, ictop0, dt, khmin, zhhatt, qsenh):
    """CUASC_NEW: entraining/detraining updraft ascent
    (cu_tiedtke.f90:1882-2382). The level loop runs as a lax.fori_loop
    with the full profile arrays in the carry (dynamic row updates), so
    the trace stays O(1) in the number of levels."""
    KLEV = tenh.shape[0]
    shape2 = tenh.shape[1:]
    zcons2 = 1.0 / (G * dt)
    zero2 = jnp.zeros(shape2, tenh.dtype)
    karr = jnp.arange(KLEV)[:, None, None]

    ktype = jnp.where(~ldcum, 0, ktype)
    klab = jnp.where((~ldcum | (ktype == 3))[None], 0, klab)
    below4e4 = paph[:KLEV] < 4e4
    kct0 = ictop0
    for k in range(KLEV):
        kct0 = jnp.where(~ldcum & below4e4[k], k, kct0)
    ictop0 = kct0

    kctop = jnp.full(shape2, KLEV - 2, jnp.int32)
    kcbot = jnp.where(~ldcum, KLEV - 2, kcbot)
    zmfub = jnp.where(~ldcum, 0.0, zmfub)
    pqu = pqu.at[KLEV - 1].set(jnp.where(~ldcum, 0.0, pqu[KLEV - 1]))

    zero3 = jnp.zeros_like(tenh)
    plu = zero3
    pmfu = zero3.at[KLEV - 1].set(zmfub)
    zmfus = zero3.at[KLEV - 1].set(
        zmfub * (CPD * ptu[KLEV - 1] + geoh[KLEV - 1]))
    zmfuq = zero3.at[KLEV - 1].set(zmfub * pqu[KLEV - 1])
    zmful = zero3
    plude = zero3
    zdmfup = zero3
    oentr = zero3
    odetr = zero3

    # organized entrainment at cloud base (orgen=1; :2050-2075)
    deep = ktype == 1
    tu_b = _lev(ptu, kcbot)
    qu_b = _lev(pqu, kcbot)
    tenh_b = _lev(tenh, kcbot)
    qenh_b = _lev(qenh, kcbot)
    zbuoy = G * ((tu_b - tenh_b) / tenh_b + 0.608 * (qu_b - qenh_b))
    zbuoy = jnp.where(deep, zbuoy, 0.0)
    geo_bm1 = _lev(geo, jnp.maximum(kcbot - 1, 0))
    geo_b = _lev(geo, kcbot)
    ten_bm1 = _lev(ten, jnp.maximum(kcbot - 1, 0))
    ten_b = _lev(ten, kcbot)
    zdz0 = (geo_bm1 - geo_b) * ZRG
    zdrodz0 = -jnp.log(ten_bm1 / ten_b) / jnp.where(zdz0 == 0, 1., zdz0) \
        - G / (RD * tenh_b)
    oentr_base = jnp.clip(zbuoy * 0.5 / (1. + zbuoy * zdz0) + zdrodz0,
                          0.0, 1e-3)
    oentr_base = jnp.where(deep & (zbuoy > 0.), oentr_base, 0.0)
    base_m1 = jnp.maximum(kcbot - 1, 0)
    oentr = jnp.where((karr == base_m1[None]), oentr_base[None], oentr)

    # mid-level onset bounds (:2116-2127); per-column leveltop
    near250 = jnp.abs(paph[1:KLEV] * 0.01 - 250.0) < 50.0
    leveltop = jnp.where(jnp.any(near250, axis=0),
                         (KLEV - 1) - jnp.argmax(near250[::-1], axis=0),
                         KLEV - 2).astype(jnp.int32)
    leveltop = jnp.minimum(KLEV - 15, leveltop)
    levelbot = KLEV - 2 - 4

    def row(a, i):
        return jax.lax.dynamic_index_in_dim(a, i, 0, keepdims=False)

    def setrow(a, i, v):
        return jax.lax.dynamic_update_index_in_dim(a, v, i, 0)

    # per-column gathers hoisted out of the level loop (these are
    # loop-invariant — ictop0/khmin never change
    # inside the loop, and paph(kcbot) is carried and refreshed on
    # mid-level onset)
    paph_top = _lev(paph, ictop0)
    ikt_geoh = _lev(geoh, ictop0)
    ikh_geoh = _lev(geoh, jnp.maximum(khmin, 0))
    zpbase0 = _lev(paph, kcbot)

    def body(it, carry):
        (ptu, pqu, plu, pmfu, zmfus, zmfuq, zmful, plude, zdmfup,
         oentr, odetr, klab, zmfub, zentr, ktype, kcbot, kctop,
         ldcum_next, zbuoy, zpbase) = carry
        jk = KLEV - 2 - it

        # CUBASMC mid-level onset (:3087-3164)
        mid = (~ldcum) & (row(klab, jk + 1) == 0) \
            & (row(qen, jk) > 0.80 * row(qsen, jk)) \
            & (jk < levelbot) & (jk > leveltop)
        ptu_jk1 = jnp.where(mid, (CPD * row(ten, jk) + row(geo, jk)
                                  - row(geoh, jk + 1)) * RCPD,
                            row(ptu, jk + 1))
        pqu_jk1 = jnp.where(mid, row(qen, jk), row(pqu, jk + 1))
        plu_jk1 = jnp.where(mid, 0.0, row(plu, jk + 1))
        zzzmb = jnp.clip(-row(verv, jk) / G, CMFCMIN, CMFCMAX)
        zmfub = jnp.where(mid, zzzmb, zmfub)
        pmfu_jk1 = jnp.where(mid, zmfub, row(pmfu, jk + 1))
        mfus_jk1 = jnp.where(mid, zmfub * (CPD * ptu_jk1
                                           + row(geoh, jk + 1)),
                             row(zmfus, jk + 1))
        mfuq_jk1 = jnp.where(mid, zmfub * pqu_jk1, row(zmfuq, jk + 1))
        mful_jk1 = jnp.where(mid, 0.0, row(zmful, jk + 1))
        dmfup_jk1 = jnp.where(mid, 0.0, row(zdmfup, jk + 1))
        kcbot = jnp.where(mid, jk, kcbot)
        zpbase = jnp.where(mid, row(paph, jk), zpbase)
        klab_jk1 = jnp.where(mid, 1, row(klab, jk + 1))
        ktype = jnp.where(mid, 3, ktype)
        zentr = jnp.where(mid, ENTRMID, zentr)

        loflag = klab_jk1 > 0
        klab_jk = jnp.where(klab_jk1 == 0, 0, row(klab, jk))
        # ktype=3 cloud-base mass-flux cap
        cap = (ktype == 3) & (kcbot == jk)
        zmfmax = (row(paph, jk) - row(paph, jk - 1)) * zcons2
        over = cap & (zmfub > zmfmax)
        zfac_c = jnp.where(over, zmfmax / jnp.maximum(zmfub, 1e-20), 1.0)
        pmfu_jk1 = pmfu_jk1 * zfac_c
        mfus_jk1 = mfus_jk1 * zfac_c
        mfuq_jk1 = mfuq_jk1 * zfac_c
        zmfub = jnp.where(over, zmfmax, zmfub)

        # CUENTR_NEW (:3331-3443), orgen/nturben = 1
        zrrho = (RD * row(tenh, jk + 1)) / row(paph, jk + 1)
        zdprho = (row(paph, jk + 1) - row(paph, jk)) * ZRG
        zpmid = 0.5 * (zpbase + paph_top)
        zentr_k = zentr * pmfu_jk1 * zdprho * zrrho
        llo1 = (jk < kcbot) & ldcum
        zdmfde = jnp.where(llo1, zentr_k, 0.0)
        llo2_s = llo1 & (ktype == 2) \
            & (((zpbase - row(paph, jk)) < ZDNOPRC)
               | (row(paph, jk) > zpmid))
        zdmfen = jnp.where(llo2_s, zentr_k, 0.0)
        iklwmin = jnp.maximum(klwmin, ictop0 + 2)
        llo2_m = llo1 & (ktype == 3) & ((jk >= iklwmin)
                                        | (row(pap, jk) > zpmid))
        zdmfen = jnp.where(llo2_m, zentr_k, zdmfen)
        llo2_d = llo1 & (ktype == 1)
        zdmfen = jnp.where(llo2_d, zentr_k, zdmfen)
        od_on = llo2_d & (jk <= khmin) & (jk >= ictop0)
        ztmzk = -(ikh_geoh - ikt_geoh) * ZRG
        zzmzk = -(ikh_geoh - row(geoh, jk)) * ZRG
        valid = od_on & (khmin > ictop0)
        arg = 3.1415 * (zzmzk / jnp.where(ztmzk == 0, 1.0, ztmzk)) * 0.5
        zorgde = jnp.tan(arg) * 3.1415 * 0.5 \
            / jnp.where(ztmzk == 0, 1.0, ztmzk)
        zdprho2 = (row(paph, jk + 1) - row(paph, jk)) * (ZRG * zrrho)
        odetr_k = jnp.where(valid,
                            jnp.minimum(zorgde, 1e-3) * pmfu_jk1
                            * zdprho2, 0.0)

        # ascent core (:2160-2260)
        in_cloud = jk < kcbot
        zmftest = pmfu_jk1 + zdmfen - zdmfde
        zmfmax2 = jnp.minimum(zmftest,
                              (row(paph, jk) - row(paph, jk - 1))
                              * zcons2)
        zdmfen = jnp.where(loflag & in_cloud,
                           jnp.maximum(zdmfen
                                       - jnp.maximum(zmftest - zmfmax2,
                                                     0.), 0.), zdmfen)
        zdmfde = jnp.minimum(zdmfde, 0.75 * pmfu_jk1)
        pmfu_k = pmfu_jk1 + zdmfen - zdmfde
        zdprho3 = (row(geoh, jk) - row(geoh, jk + 1)) * ZRG
        oentr_k = row(oentr, jk) * zdprho3 * pmfu_jk1
        zmftest2 = pmfu_k + oentr_k - odetr_k
        zmfmax3 = jnp.minimum(zmftest2,
                              (row(paph, jk) - row(paph, jk - 1))
                              * zcons2)
        oentr_k = jnp.where(loflag & in_cloud,
                            jnp.maximum(oentr_k
                                        - jnp.maximum(zmftest2 - zmfmax3,
                                                      0.), 0.),
                            jnp.where(loflag, oentr_k, 0.0))
        lim = loflag & (ktype == 1) & in_cloud & (jk <= khmin)
        zmse = CPD * ptu_jk1 + ALV * pqu_jk1 + row(geoh, jk + 1)
        znevn = (ikt_geoh - row(geoh, jk + 1)) \
            * (zmse - row(zhhatt, jk + 1)) * ZRG
        znevn = jnp.where(znevn <= 0., 1.0, znevn)
        zodmax = jnp.maximum(((zhcbase - zmse) / znevn) * zdprho3
                             * pmfu_jk1, 0.0)
        odetr_k = jnp.where(lim, jnp.minimum(odetr_k, zodmax), odetr_k)
        odetr_k = jnp.minimum(odetr_k, 0.75 * pmfu_k)
        pmfu_k = pmfu_k + oentr_k - odetr_k

        qenh_jk1 = row(qenh, jk + 1)
        tenh_jk1 = row(tenh, jk + 1)
        geoh_jk1 = row(geoh, jk + 1)
        qsenh_jk1 = row(qsenh, jk + 1)
        zqeen = qenh_jk1 * (zdmfen + oentr_k)
        zseen = (CPD * tenh_jk1 + geoh_jk1) * (zdmfen + oentr_k)
        zscde = (CPD * ptu_jk1 + geoh_jk1) * zdmfde
        zga = ALV * qsenh_jk1 / (RV * (tenh_jk1 ** 2))
        zdt = (plu_jk1 - 0.608 * (qsenh_jk1 - qenh_jk1)) \
            / (1. / tenh_jk1 + 0.608 * zga)
        zscod = CPD * tenh_jk1 + geoh_jk1 + CPD * zdt
        zscde = zscde + odetr_k * zscod
        zqude = pqu_jk1 * zdmfde + odetr_k * (qsenh_jk1 + zga * zdt)
        plude_k = plu_jk1 * (zdmfde + odetr_k)
        zmfusk = mfus_jk1 + zseen - zscde
        zmfuqk = mfuq_jk1 + zqeen - zqude
        zmfulk = mful_jk1 - plude_k
        denom = 1.0 / jnp.maximum(CMFCMIN, pmfu_k)
        plu_k = jnp.where(loflag, zmfulk * denom, row(plu, jk))
        pqu_k = jnp.where(loflag, zmfuqk * denom, row(pqu, jk))
        ptu_k = jnp.where(loflag,
                          jnp.clip((zmfusk * denom - row(geoh, jk))
                                   * RCPD, 100., 400.), row(ptu, jk))
        pmfu_k = jnp.where(loflag, pmfu_k, row(pmfu, jk))
        plude_k = jnp.where(loflag, plude_k, row(plude, jk))
        zqold = pqu_k

        ptu_k, pqu_k = cuadjtq(ptu_k, pqu_k, row(paph, jk), loflag, 1)

        condensed = loflag & (pqu_k != zqold)
        klab_jk = jnp.where(condensed, 2, klab_jk)
        plu_k = jnp.where(condensed, plu_k + zqold - pqu_k, plu_k)
        zbuo = ptu_k * (1. + VTMPC1 * pqu_k - plu_k) \
            - row(tenh, jk) * (1. + VTMPC1 * row(qenh, jk))
        zbuo = jnp.where(klab_jk1 == 1, zbuo + ZBUO0, zbuo)
        grows = condensed & (zbuo > 0.) & (pmfu_k > 0.01 * zmfub) \
            & (jk >= ictop0)
        kctop = jnp.where(grows, jk, kctop)
        ldcum_next = ldcum_next | grows
        zprcon = jnp.where(zpbase - row(paph, jk) >= ZDNOPRC,
                           CPRCON, 0.0)
        zlnew = plu_k / (1. + zprcon * (row(geoh, jk) - geoh_jk1))
        dmfup_k = jnp.where(grows,
                            jnp.maximum(0., (plu_k - zlnew) * pmfu_k),
                            0.0)
        plu_k = jnp.where(grows, zlnew, plu_k)
        killed = condensed & ~grows
        klab_jk = jnp.where(killed, 0, klab_jk)
        pmfu_k = jnp.where(killed, 0.0, pmfu_k)

        mful_k = jnp.where(loflag, plu_k * pmfu_k, row(zmful, jk))
        mfus_k = jnp.where(loflag,
                           (CPD * ptu_k + row(geoh, jk)) * pmfu_k,
                           row(zmfus, jk))
        mfuq_k = jnp.where(loflag, pqu_k * pmfu_k, row(zmfuq, jk))

        # organized entrainment for the next level up (orgen=1)
        act = loflag & (ktype == 1)
        zbuoyz = G * ((ptu_k - row(tenh, jk)) / row(tenh, jk)
                      + 0.608 * (pqu_k - row(qenh, jk)) - plu_k)
        zbuoyz = jnp.maximum(zbuoyz, 0.0)
        zdzl = (row(geo, jk - 1) - row(geo, jk)) * ZRG
        zdrodzl = -jnp.log(row(ten, jk - 1) / row(ten, jk)) \
            / jnp.where(zdzl == 0, 1., zdzl) - G / (RD * row(tenh, jk))
        zbuoy = jnp.where(act, zbuoy + zbuoyz * zdzl, zbuoy)
        oentr_next = jnp.clip(zbuoyz * 0.5 / (1. + zbuoy) + zdrodzl,
                              0.0, 1e-3)
        oentr = setrow(oentr, jk - 1,
                       jnp.where(act, oentr_next, row(oentr, jk - 1)))

        # write back updated rows
        ptu = setrow(ptu, jk, ptu_k)
        ptu = setrow(ptu, jk + 1, ptu_jk1)
        pqu = setrow(pqu, jk, pqu_k)
        pqu = setrow(pqu, jk + 1, pqu_jk1)
        plu = setrow(plu, jk, plu_k)
        plu = setrow(plu, jk + 1, plu_jk1)
        pmfu = setrow(pmfu, jk, pmfu_k)
        pmfu = setrow(pmfu, jk + 1, pmfu_jk1)
        zmfus = setrow(zmfus, jk, mfus_k)
        zmfus = setrow(zmfus, jk + 1, mfus_jk1)
        zmfuq = setrow(zmfuq, jk, mfuq_k)
        zmfuq = setrow(zmfuq, jk + 1, mfuq_jk1)
        zmful = setrow(zmful, jk, mful_k)
        zmful = setrow(zmful, jk + 1, mful_jk1)
        plude = setrow(plude, jk, plude_k)
        zdmfup = setrow(zdmfup, jk, dmfup_k)
        zdmfup = setrow(zdmfup, jk + 1, dmfup_jk1)
        odetr = setrow(odetr, jk, odetr_k)
        klab = setrow(klab, jk, klab_jk)
        klab = setrow(klab, jk + 1, klab_jk1)
        return (ptu, pqu, plu, pmfu, zmfus, zmfuq, zmful, plude,
                zdmfup, oentr, odetr, klab, zmfub, zentr, ktype, kcbot,
                kctop, ldcum_next, zbuoy, zpbase)

    ldcum_next = jnp.zeros(shape2, bool)
    carry = (ptu, pqu, plu, pmfu, zmfus, zmfuq, zmful, plude, zdmfup,
             oentr, odetr, klab, zmfub, zentr, ktype, kcbot, kctop,
             ldcum_next, zbuoy, zpbase0)
    carry = jax.lax.fori_loop(0, KLEV - 2, body, carry)
    (ptu, pqu, plu, pmfu, zmfus, zmfuq, zmful, plude, zdmfup, oentr,
     odetr, klab, zmfub, zentr, ktype, kcbot, kctop, ldcum_next,
     zbuoy, _) = carry

    # ---- fluxes above the non-buoyancy level (:2335-2375) --------------
    ldcum = ldcum_next & ~(kctop == KLEV - 2)
    kcbot = jnp.maximum(kcbot, kctop)
    topm1 = jnp.maximum(kctop - 1, 0)
    topm2 = jnp.maximum(kctop - 2, 0)
    mfu_top = _lev(pmfu, kctop)
    zdmfde_t = (1.0 - CMFCTOP) * mfu_top
    plu_top = _lev(plu, kctop)
    mfu_new = mfu_top - zdmfde_t
    ptu_m1 = _lev(ptu, topm1)
    pqu_m1 = _lev(pqu, topm1)
    plu_m1 = _lev(plu, topm1)
    mful_new = plu_m1 * mfu_new
    karr2 = jnp.arange(KLEV)[:, None, None]
    at_m1 = (karr2 == topm1[None]) & ldcum[None]
    geoh_m1 = _lev(geoh, topm1)
    pmfu = jnp.where(at_m1, mfu_new[None], pmfu)
    zmfus = jnp.where(at_m1, ((CPD * ptu_m1 + geoh_m1) * mfu_new)[None],
                      zmfus)
    zmfuq = jnp.where(at_m1, (pqu_m1 * mfu_new)[None], zmfuq)
    zmful = jnp.where(at_m1, mful_new[None], zmful)
    zdmfup = jnp.where(at_m1, 0.0, zdmfup)
    plude = jnp.where(at_m1, (zdmfde_t * plu_top)[None], plude)
    at_m2 = (karr2 == topm2[None]) & ldcum[None] & (topm2 != topm1)[None]
    plude = jnp.where(at_m2, mful_new[None], plude)
    at_edge = at_m1 & (topm1 == 0)[None]
    plude = jnp.where(at_edge, mful_new[None], plude)
    return (ldcum, ktype, kcbot, kctop, ptu, pqu, plu, pmfu, zmfus,
            zmfuq, zmful, plude, zdmfup, klab)


def cudlfs_cuddraf(tenh, qenh, geoh, paph, ptu, pqu, ldcum, kcbot,
                   kctop, zmfub, zrfl_in):
    """Downdraft LFS detection + moist descent
    (CUDLFS :2388-2524 and CUDDRAF :2531-2664)."""
    KLEV = tenh.shape[0]
    shape2 = tenh.shape[1:]
    zero2 = jnp.zeros(shape2, tenh.dtype)
    lddraf = jnp.zeros(shape2, bool)
    kdtop = jnp.full(shape2, KLEV, jnp.int32)
    zrfl = zrfl_in

    ztd_r = [tenh[k] for k in range(KLEV)]
    zqd_r = [qenh[k] for k in range(KLEV)]
    pmfd_r = [zero2] * KLEV
    mfds_r = [zero2] * KLEV
    mfdq_r = [zero2] * KLEV
    dmfdp_r = [zero2] * KLEV

    # CUDLFS: scan from top of cloud downward
    for jk in range(2, KLEV - 3):
        llo2 = ldcum & (zrfl > 0.) & ~lddraf & (jk < kcbot) & (jk > kctop)
        ztenwb, zqenwb = cuadjtq(tenh[jk], qenh[jk], paph[jk], llo2, 2)
        zttest = 0.5 * (ptu[jk] + ztenwb)
        zqtest = 0.5 * (pqu[jk] + zqenwb)
        zbuo = zttest * (1. + VTMPC1 * zqtest) \
            - tenh[jk] * (1. + VTMPC1 * qenh[jk])
        zcond = qenh[jk] - zqenwb
        zmftop = -CMFDEPS * zmfub
        hit = llo2 & (zbuo < 0.) & (zrfl > 10. * zmftop * zcond)
        kdtop = jnp.where(hit, jk, kdtop)
        lddraf = lddraf | hit
        ztd_r[jk] = jnp.where(hit, zttest, ztd_r[jk])
        zqd_r[jk] = jnp.where(hit, zqtest, zqd_r[jk])
        pmfd_r[jk] = jnp.where(hit, zmftop, pmfd_r[jk])
        mfds_r[jk] = jnp.where(hit, zmftop * (CPD * zttest + geoh[jk]),
                               mfds_r[jk])
        mfdq_r[jk] = jnp.where(hit, zmftop * zqtest, mfdq_r[jk])
        dp = -0.5 * zmftop * zcond
        dmfdp_r[jk - 1] = jnp.where(hit, dp, dmfdp_r[jk - 1])
        zrfl = zrfl + jnp.where(hit, dp, 0.0)

    # CUDDRAF: moist descent
    itopde = KLEV - 3   # 1-based KLEV-2 -> 0-based KLEV-3
    for jk in range(2, KLEV):
        llo2 = lddraf & (pmfd_r[jk - 1] < 0.)
        zentr = ENTRDD * pmfd_r[jk - 1] * RD * tenh[jk - 1] \
            / (G * paph[jk - 1]) * (paph[jk] - paph[jk - 1])
        zdmfen = zentr
        zdmfde = zentr
        if jk > itopde:
            zdmfen = jnp.zeros_like(zentr)
            zdmfde = pmfd_r[itopde] * (paph[jk] - paph[jk - 1]) \
                / (paph[KLEV] - paph[itopde])
        pmfd_k = pmfd_r[jk - 1] + zdmfen - zdmfde
        # entrain environment values, detrain downdraft values
        zseen = (CPD * tenh[jk - 1] + geoh[jk - 1]) * zdmfen
        zqeen = qenh[jk - 1] * zdmfen
        zsdde = (CPD * ztd_r[jk - 1] + geoh[jk - 1]) * zdmfde
        zqdde = zqd_r[jk - 1] * zdmfde
        zmfdsk = mfds_r[jk - 1] + zseen - zsdde
        zmfdqk = mfdq_r[jk - 1] + zqeen - zqdde
        denom = 1.0 / jnp.minimum(-CMFCMIN, pmfd_k)
        zqd_k = zmfdqk * denom
        ztd_k = jnp.clip((zmfdsk * denom - geoh[jk]) * RCPD, 100., 400.)
        zqd_k = jnp.where(llo2, zqd_k, zqd_r[jk])
        ztd_k = jnp.where(llo2, ztd_k, ztd_r[jk])
        pmfd_k = jnp.where(llo2, pmfd_k, pmfd_r[jk])
        zcond = zqd_k
        ztd_k, zqd_k = cuadjtq(ztd_k, zqd_k, paph[jk], llo2, 2)
        zcond = jnp.where(llo2, zcond - zqd_k, 0.0)
        zbuo = ztd_k * (1. + VTMPC1 * zqd_k) \
            - tenh[jk] * (1. + VTMPC1 * qenh[jk])
        kill = llo2 & ((zbuo >= 0.) | (zrfl <= (pmfd_k * zcond)))
        pmfd_k = jnp.where(kill, 0.0, pmfd_k)
        mfds_k = jnp.where(llo2, (CPD * ztd_k + geoh[jk]) * pmfd_k,
                           mfds_r[jk])
        mfdq_k = jnp.where(llo2, zqd_k * pmfd_k, mfdq_r[jk])
        zdmfdp = jnp.where(llo2, -pmfd_k * zcond, 0.0)
        dmfdp_r[jk - 1] = jnp.where(llo2, zdmfdp, dmfdp_r[jk - 1])
        zrfl = zrfl + zdmfdp
        ztd_r[jk] = ztd_k
        zqd_r[jk] = zqd_k
        pmfd_r[jk] = pmfd_k
        mfds_r[jk] = mfds_k
        mfdq_r[jk] = mfdq_k

    return (jnp.stack(ztd_r), jnp.stack(zqd_r), jnp.stack(pmfd_r),
            jnp.stack(mfds_r), jnp.stack(mfdq_r), jnp.stack(dmfdp_r),
            kdtop, lddraf)


def cuflx(qen, qsen, tenh, qenh, paph, geoh, kcbot, kctop, kdtop,
          ktype, lddraf, ldcum, pmfu, pmfd, zmfus, zmfds, zmfuq, zmfdq,
          zmful, plude, zdmfup, zdmfdp, ten, dt, sig1):
    """Final flux adjustments, melt + sub-cloud evaporation
    (CUFLX, cu_tiedtke.f90:2670-2860)."""
    KLEV = qen.shape[0]
    shape2 = qen.shape[1:]
    zcons1 = CPD / (ALF * G * dt)
    zcons2 = 1.0 / (G * dt)
    zcucov = 0.05
    ztmelp2 = TMELT + 2.0
    karr = jnp.arange(KLEV)[:, None, None]

    lddraf = lddraf & ldcum & ~(kdtop < kctop)
    ktype = jnp.where(~ldcum, 0, ktype)

    in_up = ldcum[None] & (karr >= (kctop - 1)[None])
    sref = CPD * tenh + geoh
    zmfus = jnp.where(in_up, zmfus - pmfu * sref, 0.0)
    zmfuq = jnp.where(in_up, zmfuq - pmfu * qenh, 0.0)
    in_dd = in_up & lddraf[None] & (karr >= kdtop[None])
    zmfds = jnp.where(in_dd, zmfds - pmfd * sref, 0.0)
    zmfdq = jnp.where(in_dd, zmfdq - pmfd * qenh, 0.0)
    pmfd = jnp.where(in_dd, pmfd, 0.0)
    pmfu = jnp.where(in_up, pmfu, 0.0)
    zmful = jnp.where(in_up, zmful, 0.0)
    # zero precip/detrain sources outside the cloud column (shifted one
    # level in the reference; applied unshifted here over the dead zone)
    zdmfup = jnp.where(in_up, zdmfup, 0.0)
    zdmfdp = jnp.where(in_dd, zdmfdp, 0.0)
    plude = jnp.where(in_up, plude, 0.0)

    # subcloud-layer linear flux decrease (:2782-2800)
    below = ldcum[None] & (karr > kcbot[None])
    paph_s = paph[KLEV]
    paph_b = _lev(paph, kcbot)
    zzp = (paph_s[None] - paph[:KLEV]) \
        / jnp.maximum((paph_s - paph_b)[None], 1e-10)
    zzp = jnp.where((ktype == 3)[None], zzp ** 2, zzp)
    mfu_b = _lev(pmfu, kcbot)[None]
    pmfu = jnp.where(below, mfu_b * zzp, pmfu)
    zmfus = jnp.where(below, _lev(zmfus, kcbot)[None] * zzp, zmfus)
    zmfuq = jnp.where(below, _lev(zmfuq, kcbot)[None] * zzp, zmfuq)
    zmful = jnp.where(below, _lev(zmful, kcbot)[None] * zzp, zmful)

    # rain/snow split with snowmelt (:2802-2830), top-down scan
    prain = jnp.sum(jnp.where(ldcum[None], zdmfup, 0.0), axis=0)
    prfl = jnp.zeros(shape2, qen.dtype)
    psfl = jnp.zeros(shape2, qen.dtype)
    zdpmel_r = []
    for jk in range(KLEV):
        act = ldcum
        warm = ten[jk] > TMELT
        src = zdmfup[jk] + zdmfdp[jk]
        melt_on = warm & (psfl > 0.) & (ten[jk] > ztmelp2)
        zfac = zcons1 * (paph[jk + 1] - paph[jk])
        zsnmlt = jnp.where(act & melt_on,
                           jnp.minimum(psfl, zfac * (ten[jk] - ztmelp2)),
                           0.0)
        zdpmel_r.append(zsnmlt)
        prfl = prfl + jnp.where(act & warm, src + zsnmlt, 0.0)
        psfl = psfl + jnp.where(act & warm, -zsnmlt,
                                jnp.where(act, src, 0.0))
    zdpmel = jnp.stack(zdpmel_r)
    prfl = jnp.maximum(prfl, 0.0)
    psfl = jnp.maximum(psfl, 0.0)

    # sub-cloud evaporation of precipitation (:2832-2858)
    zpsubcl = prfl + psfl
    for jk in range(KLEV):
        act = ldcum & (jk >= kcbot) & (zpsubcl > 1e-20)
        zrfl_l = zpsubcl
        cevapcu = CEVAPCU1 * jnp.sqrt(CEVAPCU2 * jnp.sqrt(sig1[jk]))
        zrnew = (jnp.maximum(0., jnp.sqrt(zrfl_l / zcucov)
                             - cevapcu * (paph[jk + 1] - paph[jk])
                             * jnp.maximum(0., qsen[jk] - qen[jk]))) \
            ** 2 * zcucov
        zrmin = zrfl_l - zcucov \
            * jnp.maximum(0., 0.8 * qsen[jk] - qen[jk]) * zcons2 \
            * (paph[jk + 1] - paph[jk])
        zrfln = jnp.maximum(jnp.maximum(zrnew, zrmin), 0.0)
        zdrfl = jnp.minimum(0., zrfln - zrfl_l)
        zdmfup = zdmfup.at[jk].add(jnp.where(act, zdrfl, 0.0))
        zpsubcl = jnp.where(act, zrfln, zpsubcl)
    zdpevap = zpsubcl - (prfl + psfl)
    tot = jnp.maximum(1e-20, prfl + psfl)
    prfl = prfl + zdpevap * prfl / tot
    psfl = psfl + zdpevap * psfl / tot

    return (pmfu, pmfd, zmfus, zmfds, zmfuq, zmfdq, zmful, plude,
            zdmfup, zdmfdp, prfl, psfl, zdpmel, prain, ldcum, ktype)


def cudtdq(paph, ldcum, ten, zmfus, zmfds, zmfuq, zmfdq, zmful, zdmfup,
           zdmfdp, zdpmel, qen, qsen, plude):
    """T/q tendencies from flux divergence
    (CUDTDQ, cu_tiedtke.f90:2862-2975). Returns (tte, qte, cte)."""
    KLEV = ten.shape[0]
    zalv = jnp.where(ten > TMELT, ALV, ALS)
    rhk = jnp.minimum(1.0, qen / qsen)
    rhcoe = jnp.maximum(0.0, (rhk - RHC) / (RHM - RHC))
    pldfd = jnp.maximum(0.0, rhcoe * FDBK * plude)
    dp = paph[1:] - paph[:-1]
    godp = G / dp
    # interior levels use flux differences; lowest level uses fluxes
    mfus1 = jnp.concatenate([zmfus[1:], jnp.zeros_like(zmfus[:1])], 0)
    mfds1 = jnp.concatenate([zmfds[1:], jnp.zeros_like(zmfus[:1])], 0)
    mfuq1 = jnp.concatenate([zmfuq[1:], jnp.zeros_like(zmfus[:1])], 0)
    mfdq1 = jnp.concatenate([zmfdq[1:], jnp.zeros_like(zmfus[:1])], 0)
    mful1 = jnp.concatenate([zmful[1:], jnp.zeros_like(zmfus[:1])], 0)
    interior = jnp.arange(KLEV)[:, None, None] < (KLEV - 1)
    dtdt_i = godp * RCPD * (mfus1 - zmfus + mfds1 - zmfds
                            - ALF * zdpmel
                            - zalv * (mful1 - zmful - pldfd
                                      - (zdmfup + zdmfdp)))
    dqdt_i = godp * (mfuq1 - zmfuq + mfdq1 - zmfdq + mful1 - zmful
                     - pldfd - (zdmfup + zdmfdp))
    dtdt_b = -godp * RCPD * (zmfus + zmfds + ALF * zdpmel
                             - zalv * (zmful + zdmfup + zdmfdp + pldfd))
    dqdt_b = -godp * (zmfuq + zmfdq + pldfd
                      + (zmful + zdmfup + zdmfdp))
    tte = jnp.where(ldcum[None], jnp.where(interior, dtdt_i, dtdt_b),
                    0.0)
    qte = jnp.where(ldcum[None], jnp.where(interior, dqdt_i, dqdt_b),
                    0.0)
    cte = jnp.where(ldcum[None], godp * pldfd, 0.0)
    return tte, qte, cte


def tiedtke(u, v, w_if, t, qv, qc, qi, exner, rho, qv_tend_adv,
            qv_tend_pbl, p, p_i, dz, qfx, hfx, xland, dt):
    """One Tiedtke convection step on model-layout arrays
    (CU_TIEDTKE + TIECNV, cu_tiedtke.f90:148-711).

    Inputs (z, y, x) bottom-up; w_if is real vertical velocity at layer
    interfaces (nz+1). Returns (th_new, qv_new, qc_new, qi_new,
    rain_delta_mm)."""
    nz = t.shape[0]
    # omega at mass levels
    omg_mass = -0.5 * G * rho * (w_if[:-1] + w_if[1:])
    # mid-layer heights
    zi = jnp.concatenate([jnp.zeros_like(dz[:1]), jnp.cumsum(dz, 0)], 0)
    zl = 0.5 * (zi[:-1] + zi[1:])

    flip = lambda a: jnp.flip(a, axis=0)
    ten = flip(t)
    qen_mr = flip(qv)
    pap = flip(p)
    paph = jnp.flip(p_i, axis=0)      # (nz+1,...) index 0 = top
    geo = flip(zl) * G
    verv = flip(omg_mass)
    uen = flip(u)
    ven = flip(v)
    qte_mr = flip(qv_tend_adv + qv_tend_pbl)

    # specific humidity conversions (TIECNV :640-662)
    qen = qen_mr / (1.0 + qen_mr)
    qsen = _qsat(ten, pap)
    qte = qte_mr                      # tendency approx as in reference
    lndj = jnp.where(xland == 1.0, 1, 0)
    sig1 = pap / paph[nz][None]

    tte, qte_add, cte, rsfc, ssfc, ldcum = cumastr(
        ten, qen, uen, ven, verv, qsen, qfx, dt, pap, paph, geo, qte,
        lndj, sig1)

    # detrained cloud water/ice split (TIECNV :676-700)
    ztpp1 = ten + tte * dt
    ztc = ztpp1 - T000
    fliq = jnp.where(ztpp1 >= T000, 1.0,
                     jnp.where(ztpp1 <= HGFR, 0.0,
                               0.0059 + 0.9941
                               * jnp.exp(-0.003102 * ztc * ztc)))
    zalf = jnp.where(ztpp1 >= T000, 0.0, ALF)
    has_cte = cte > 0.0
    qc_f = flip(qc) + jnp.where(has_cte, fliq * cte * dt, 0.0)
    qi_f = flip(qi) + jnp.where(has_cte, (1. - fliq) * cte * dt, 0.0)
    tte = tte - jnp.where(has_cte, zalf * RCPD * fliq * cte, 0.0)

    t_new = ten + tte * dt
    qsp1 = qen + qte_add * dt
    qv_new_mr = qsp1 / (1.0 - qsp1)
    rain = jnp.maximum(0.0, (rsfc + ssfc) * dt)

    th_new = flip(t_new) / exner
    return (th_new, flip(qv_new_mr), flip(qc_f), flip(qi_f), rain)
