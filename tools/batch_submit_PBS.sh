#!/bin/bash
# Self-resubmitting PBS driver for a chained icar_tpu run.
# Counterpart of /root/reference/helpers/batch_submit_PBS.sh;
# see batch_submit_SLURM.sh for the chaining logic. Submit with:
#   qsub tools/batch_submit_PBS.sh
#
#PBS -N icar_tpu
#PBS -l walltime=01:00:00
#PBS -j oe
#PBS -o job_output/

set -u
cd "${PBS_O_WORKDIR:-.}"
PREFIX=${PREFIX:-run}
OPTFILE=${OPTFILE:-options.nml}
BATCHFILE=${BATCHFILE:-tools/batch_submit_PBS.sh}
REPO=${REPO:-$(pwd)}
SETUP_RUN="python $REPO/tools/setup_next_run.py"

mkdir -p job_output

if [[ ! -e ${PREFIX}_finished ]]; then
    NEXT=$(qsub -W depend=afternotok:${PBS_JOBID} ${BATCHFILE})

    if [[ -e ${PREFIX}_running ]]; then
        $SETUP_RUN $OPTFILE > job_output/py_setup.out
    fi
    touch ${PREFIX}_running

    if python -m icar_tpu $OPTFILE; then
        touch ${PREFIX}_finished
        qdel "$NEXT" || true
    fi
fi
