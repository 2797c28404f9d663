#!/bin/bash
# Self-resubmitting SLURM driver for a chained icar_tpu run.
# Counterpart of /root/reference/helpers/batch_submit_SLURM.sh:
# each job resumes from the newest restart checkpoint (via
# tools/setup_next_run.py), submits its successor with an
# afternotok dependency, and stops resubmitting once the model reaches
# its end date (the driver exits 0 and we touch ${PREFIX}_finished).
#
# Adjust the SBATCH header + PREFIX/OPTFILE for your site, then:
#   sbatch tools/batch_submit_SLURM.sh
#
#SBATCH --job-name="icar_tpu"
#SBATCH --nodes=1
#SBATCH --time=01:00:00
#SBATCH --output=job_output/log-%x.%j.out
#SBATCH --error=job_output/log-%x.%j.err

set -u
PREFIX=${PREFIX:-run}
OPTFILE=${OPTFILE:-options.nml}
BATCHFILE=${BATCHFILE:-tools/batch_submit_SLURM.sh}
REPO=${REPO:-$(cd "$(dirname "$0")/.." && pwd)}
SETUP_RUN="python $REPO/tools/setup_next_run.py"

mkdir -p job_output

if [[ ! -e ${PREFIX}_finished ]]; then
    # queue the successor first so a crash/timeout still chains
    sbatch --dependency=afternotok:${SLURM_JOB_ID} ${BATCHFILE}

    # resume from the latest checkpoint on reruns
    if [[ -e ${PREFIX}_running ]]; then
        $SETUP_RUN $OPTFILE > job_output/py_setup.out
    fi
    touch ${PREFIX}_running

    if python -m icar_tpu $OPTFILE; then
        touch ${PREFIX}_finished
        # completed: cancel the queued successor
        scancel --name="$SLURM_JOB_NAME" --state=PENDING || true
    fi
fi
